# -*- coding: utf-8 -*-
"""Suite statistics on the card: ``python -m mcsas_tpu_torch.tools.bench
--suite`` run N times, one process after another, and per config the
median and spread of its warm wall and of its proposals to converge.

The counterpart of the JAX package's tools/suite_stats.py.  Per config:
``seconds_warm`` and ``total_iters``, each as median, min, max and the
relative spread (max − min) / median; the converged repetitions of every
run; the card's name and power limit.  One seed repeats one trajectory,
so a ``total_iters`` spread above 0 is a fault of the program, not noise.
A run that exits non-zero fails the tool (exit 1).  Needs a card (it exits
with an error naming it otherwise):

    python -m mcsas_tpu_torch.tools.suite_stats [--runs 5] [--out f.json]
        [--only=sphere,cylinders-isotropic]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

_REPO = pathlib.Path(__file__).resolve().parents[2]


def spread(values) -> dict:
    """Median, min, max and (max − min) / median of *values*."""
    med = statistics.median(values)
    lo, hi = min(values), max(values)
    return {"median": med, "min": lo, "max": hi,
            "spread": (hi - lo) / med if med else 0.0}


def summarize(runs) -> dict:
    """{config: statistics} of *runs*, each run the list of bench's suite
    lines (dicts) of one process."""
    by_config = {}
    for lines in runs:
        for d in lines:
            by_config.setdefault(d["config"], []).append(d)
    return {name: {
        "n": len(rows),
        "seconds_warm": spread([d["seconds_warm"] for d in rows]),
        "total_iters": spread([d["total_iters"] for d in rows]),
        "converged_reps": [d["converged_reps"] for d in rows],
        "device": sorted({d["device"] for d in rows})}
        for name, rows in by_config.items()}


def run_suite(only=None) -> list:
    """One ``bench --suite`` process from the checkout: its lines; raises
    RuntimeError, with the tail of its errors, unless it exits 0."""
    env = dict(os.environ)
    env.setdefault("MCSAS_TPU_TABLE_CACHE_DIR", str(_REPO / ".table_cache"))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO), env.get("PYTHONPATH", "")) if p)
    cmd = [sys.executable, "-m", "mcsas_tpu_torch.tools.bench", "--suite"]
    if only:
        cmd.append("--only=" + ",".join(only))
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=_REPO,
                       env=env, timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(f"bench --suite exited {r.returncode}: "
                           f"{r.stderr[-1500:]}")
    return [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]


def build_parser() -> argparse.ArgumentParser:
    from .bench import row_names
    ap = argparse.ArgumentParser(
        prog="python -m mcsas_tpu_torch.tools.suite_stats",
        description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5,
                    help="sequential suite processes (default 5)")
    ap.add_argument("--out", default=None,
                    help="write the statistics here as JSON")
    ap.add_argument("--only", type=row_names, action="extend", default=None,
                    help="comma-separated suite rows, passed to bench")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.profiling import require_card
    require_card("suite_stats")
    runs = []
    for i in range(args.runs):
        try:
            runs.append(run_suite(args.only))
        except RuntimeError as e:
            print(json.dumps({"run": i, "error": str(e)}), flush=True)
            return 1
        print(json.dumps({"run": i, "done": True}), file=sys.stderr,
              flush=True)
    out = summarize(runs)
    for name, stats in out.items():
        print(json.dumps({"config": name, **stats}), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
