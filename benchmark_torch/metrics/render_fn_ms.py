"""render_fn_ms (ops.render): the benchmark's span around make_render_fn
(make_sharded_render_fn on several cards), synchronised, mean over the
window's jobs."""


def read(run):
    jobs = [j for j in run.jobs if j.start < run.t_close]
    if run.trace is None or not jobs:
        return None
    return sum(j.fn_s for j in jobs) / len(jobs) * 1e3
