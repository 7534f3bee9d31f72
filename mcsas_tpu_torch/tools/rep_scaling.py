# -*- coding: utf-8 -*-
"""Repetition scaling on one card: throughput and wall against the
number of repetitions R (and the contributions N).

The counterpart of the JAX package's tools/rep_scaling.py.  K1 and K2 run
one block per repetition, so at the headline's R = 10 they keep 10 of an
H100's 132 SMs busy; this curve says how aggregate proposals/s grow as
more repetitions fill the card (132: one block on each SM), and how the
wall grows with them, since a fit runs until its slowest repetition
converges.  Per R it builds one engine on the card, runs it once to warm
up and then twice, and keeps the run with the smaller wall: every value
of a row comes from that run.  Each row gives the launches of the kernel
that ran (K1 on ``--tier sphere``, the Sphere headline config; K2 on
``--tier cylinders-table``, the cylinder row of tools/suite.py), and a
row whose kernel launched no time is an error; a row whose repetitions
did not all converge says so and gives its χ² range.  Needs a card (it
exits with an error naming it otherwise):

    python -m mcsas_tpu_torch.tools.rep_scaling [--reps 1,2,5,10,20,40,80,132]
        [--contribs 300] [--tier sphere|cylinders-table] [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

REPS = "1,2,5,10,20,40,80,132"
TIERS = ("sphere", "cylinders-table")


def tier_workload(tier: str, n_reps: int, n_contribs: int):
    """(data, bound, cfg) of *tier* at *n_reps* x *n_contribs*: the
    Sphere headline (bench.py's, the JAX tool's config) or the cylinder
    row of tools/suite.py."""
    from . import roofline, suite
    if tier == "sphere":
        return roofline.headline_workload(num_contribs=n_contribs,
                                          num_reps=n_reps)
    if tier == "cylinders-table":
        return (suite.cylinder_golden(), suite.cylinder_bound(),
                suite.cylinder_config(num_reps=n_reps,
                                      num_contribs=n_contribs))
    raise ValueError(f"unknown tier {tier!r}; one of {TIERS}")


def _counters():
    from ..ops import mc_kernel
    return {"mc_chunk": (mc_kernel.run_chunk,),
            "mc_prefetch": (mc_kernel.run_prefetch_table_chunk,
                            mc_kernel.run_prefetch_chunk)}


def measure(tier: str, n_reps: int, n_contribs: int, card: str) -> dict:
    """One row: warm-up, then the better of two runs of one engine."""
    import torch

    from ..core.engine import McSASEngine
    data, bound, cfg = tier_workload(tier, n_reps, n_contribs)
    eng = McSASEngine(data, bound, cfg, device="cuda")
    kernel = "mc_prefetch" if eng.runs_prefetch else "mc_chunk"
    counters = _counters()
    eng.run()
    wall, best, launches = float("inf"), None, 0
    for _ in range(2):
        for fn in (f for fns in counters.values() for f in fns):
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if dt < wall:                 # keep the run that set the minimum,
            wall, best = dt, res      # so that the row is one run's
            launches = sum(fn.launches for fn in counters[kernel])
            others = {k: sum(fn.launches for fn in fns)
                      for k, fns in counters.items() if k != kernel}
    if launches <= 0 or any(others.values()):
        raise AssertionError(f"{tier} R={n_reps} N={n_contribs}: {kernel} "
                             f"launched {launches} times, the others "
                             f"{others}")
    pps = best.total_iters / wall
    return {
        "tier": tier, "reps": n_reps, "contribs": n_contribs,
        "wall_s": wall, "proposals_per_sec": pps,
        "per_rep_proposals_per_sec": pps / n_reps,
        "total_proposals": int(best.total_iters),
        "converged": int(best.converged.sum()),
        "all_converged": bool(best.converged.all()),
        "chi2_min": float(best.conval.min()),
        "chi2_max": float(best.conval.max()),
        "kernel": kernel, "launches": launches, "card": card}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mcsas_tpu_torch.tools.rep_scaling",
        description=__doc__.split("\n")[0])
    ap.add_argument("--reps", default=REPS,
                    help=f"comma-separated repetition counts (default "
                         f"{REPS})")
    ap.add_argument("--contribs", type=int, default=300,
                    help="contributions per repetition (default 300)")
    ap.add_argument("--tier", choices=TIERS, default="sphere")
    ap.add_argument("--json", default=None, help="write the rows here")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    reps = [int(r) for r in args.reps.split(",")]
    from ..utils.profiling import card_line, require_card
    require_card("rep_scaling")
    import torch
    card = card_line()
    rows = []
    for n_reps in reps:
        row = measure(args.tier, n_reps, args.contribs, card)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "card": card, "rows": rows}, fh, indent=1)
        print("wrote", args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
