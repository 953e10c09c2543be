"""lut_load_ms (tasks.runner): the benchmark's span around
load_lut_table, synchronised, mean over the window's jobs (a cache hit
costs a lookup, a miss a parse and an upload)."""


def read(run):
    jobs = [j for j in run.jobs if j.start < run.t_close]
    if run.trace is None or not jobs:
        return None
    return sum(j.load_s for j in jobs) / len(jobs) * 1e3
