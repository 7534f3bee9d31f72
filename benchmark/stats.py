"""The arithmetic of the metrics: rates, percentiles, spreads and the
device's timeline."""
import math
import statistics


def p95(walls, failed, window_s):
    """The 95th percentile (nearest rank) of the fits' *walls*, where a
    fit in *failed* (booleans) counts as the whole window, slower than any
    completed one."""
    ranked = sorted(window_s if bad else w for w, bad in zip(walls, failed))
    return ranked[max(0, math.ceil(0.95 * len(ranked)) - 1)]


def spread(values):
    """The distance between the first and third quartile over the median
    (Python's ``statistics.quantiles``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def merge(intervals):
    """Disjoint sorted (start, end) covering *intervals*."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_in(intervals, lo, hi):
    """The length of [lo, hi] that *intervals* cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in merge(intervals))


def gaps(intervals, lo, hi):
    """The stretches of [lo, hi] that *intervals* leave uncovered."""
    out, at = [], lo
    for s, e in merge(intervals):
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def label_gaps(gap_list, spans, outside="outside any span"):
    """Idle seconds by the innermost host span (name, start, end) that
    holds each gap's midpoint: {name: seconds}."""
    out = {}
    for s, e in gap_list:
        mid = 0.5 * (s + e)
        holding = [(se - ss, name) for name, ss, se in spans
                   if ss <= mid <= se]
        name = min(holding)[1] if holding else outside
        out[name] = out.get(name, 0.0) + (e - s)
    return out
