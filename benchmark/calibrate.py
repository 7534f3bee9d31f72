"""The readings the check's limits are set from, on the card: for each
seed one short run of a cell in this process, the program's checks and
the control's (the reference in bfloat16 in the program's place), one
JSON line a seed, then the largest program reading and the smallest
control reading of each check.  The benchmark's own runs do not run it.

    python -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 5
"""
import argparse
import json
import sys
import time

from . import run


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    type=lambda s: [int(v) for v in s.split(",") if v])
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("benchmark.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    run.cache_env()
    piece = run.load_cell(args.workload)
    lows, highs = {}, {}
    for seed in args.seeds:
        rec = run.run_cell(piece, seed, args.seconds, control=True,
                           t_start=time.perf_counter())
        fits = rec["fits"]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "fits": len(fits),
            "checked": rec["checked_fits"],
            "fits_per_s": sum(f["converged"] for f in fits)
            / rec["window_s"],
            "failed": sum(not f["converged"] for f in fits),
            "program": rec["checks"], "control": rec["control"]}),
            flush=True)
        for k, v in rec["checks"].items():
            lows[k] = max(lows.get(k, 0.0), v)
        for k, v in rec["control"].items():
            highs[k] = min(highs.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "program_max": lows, "control_min": highs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
