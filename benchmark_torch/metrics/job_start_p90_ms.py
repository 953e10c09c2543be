"""job_start_p90_ms: over every job started in the window, the time from
its start (before load_lut_table) to its first output batch reaching the
consumer; the 90th percentile. A stream has no job starts."""

from benchmark_torch.readers import percentile


def read(run):
    if run.cell.traffic["kind"] != "queue":
        return None
    return percentile([(j.first - j.start) * 1e3 for j in run.jobs
                       if j.start < run.t_close and j.first is not None], 90)
