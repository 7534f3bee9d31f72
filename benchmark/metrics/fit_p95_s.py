"""The 95th percentile of the fits' walls, each on the host clock around
``fit()`` ending in a synchronize; a failed fit counts as the window."""
from benchmark import stats


def read(rec):
    fits = rec["fits"]
    return stats.p95([f["wall_s"] for f in fits],
                     [not f["converged"] for f in fits], rec["window_s"])
