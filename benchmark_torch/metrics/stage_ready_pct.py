"""stage_ready_pct (engine.executor): the window's batches that the
device loop found already staged (its executor.stage spans with the
attribute ``ready`` true), over the batches it staged (the spans that
carry ``ready``), in percent. A program whose stage step stages no batch
ahead carries no ``ready`` and reads None."""

from benchmark_torch.spans import window


def read(run):
    steps = [r for r in window(run, "executor.stage") or ()
             if "ready" in r.attrs]
    if not steps:
        return None
    return 100.0 * sum(r.attrs["ready"] is True for r in steps) / len(steps)
