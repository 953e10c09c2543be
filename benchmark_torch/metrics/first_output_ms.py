"""first_output_ms (engine.executor): from the start of the program's
executor.run span (a render_batches call) to its first output, mean over
the window's calls (host clock)."""

from benchmark_torch.spans import window


def read(run):
    firsts = [r.attrs["first_yield_ns"] for r in window(run, "executor.run")
              or () if "first_yield_ns" in r.attrs]
    return sum(firsts) / len(firsts) * 1e-6 if firsts else None
