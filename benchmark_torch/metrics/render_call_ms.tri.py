"""render_call_ms.tri (ops.render): render_call_ms over the render calls
whose executor.render span says they ran kernel B's trilinear
instantiation (attributes ``layout`` "fused" and ``interp``
"trilinear"), mean over those batches (host clock). None where no call
carries the attributes, as in a program that sets none."""

from benchmark_torch.spans import mean_ms, window


def read(run):
    calls = window(run, "executor.render")
    return mean_ms([r for r in calls or ()
                    if r.attrs.get("layout") == "fused"
                    and r.attrs.get("interp") == "trilinear"])
