# -*- coding: utf-8 -*-
"""Headline benchmark of the port on the card, its suite and its
certification: the counterpart of the JAX package's bench.py.

**The headline** (default) follows bench.py:247-340: the Sphere fit of
``testdata/sasfit_sphere-10-1.dat`` (300 contributions × 10 repetitions,
K=128, local moves 0.5, chunks of 2048, budget 8 M, seed 2026, one retry)
on one engine: a warm-up ``run()``, then ``mc_s``, the better of two
``run()``s; a warm-up ``fit()``, then ``value``, the better of two
``fit()``s (MC, float64 post pass, histograms); the reference's
quickstart workload on ``testdata/quickstartdemo1.csv`` (its radius range
the data's size estimate), a warm-up and the better of two.  ``value`` is
-1.0 unless every repetition converged.  One JSON line with bench.py's
keys, its ``device`` the card's name and power limit, plus ``launches``
(K1 and K2's two entries in the timed fit that set ``value``) and
``total_iters``.  ``--trace=DIR`` runs one more ``run()`` under
torch.profiler and writes its trace into DIR (bench.py's ``--trace``).

**The suite** (``--suite [--only=a,b]``): bench.py's nine rows in its
order (``tools/suite.py``'s ``BENCH_ROWS``), each a cold ``fit()`` then a
warm one, one line each with bench.py's keys (bench.py:229-243) plus
``device`` and ``launches`` (of the warm fit).  ``pallas`` says that a
CUDA chunk kernel ran (K1 or K2, as the JAX package's ``used_pallas``
counts its prefetch kernel), ``table`` that the rows came from a table.

**Certify** (with the headline, unless ``--no-certify``).  The JAX
certify compares the TPU's single-launch drive with a host loop; the port
has no drive, so on the card it holds the kernels' own handling of the
state and the per-shard launches instead, on bench.py's tiers
(``sphere``: K1; ``kholodenko-worm``: K2's table entry with the worm's
cross-section and local moves 0.75; ``cylinders-isotropic``: K2's table
entry) at the drive audit's config (:data:`CERTIFY`, max_retries 0):

* a tier row: two ``run()``s of one seed on one engine — ``n_iter_equal``
  per repetition and ``inflation``, the second run's proposals over the
  first's, which must be 1.0;
* a sharded row (``sphere`` and ``kholodenko-worm``): a
  ``parallel.ShardedEnsemble`` of two repetition shards on the one card,
  each launching on its own stream, against the unsharded run —
  ``n_iter_equal``, ``contribs_equal``, ``inflation`` and the launches per
  shard.

A failing row is recorded in the line and not raised, so the timing
survives (bench.py:352-353); the process then exits 1.

Needs a card: without one it prints one JSON line with ``value`` -1.0 and
an ``error`` naming the missing CUDA device, and exits 1 (it never times
the CPU).  ``MCSAS_TPU_TABLE_CACHE_DIR`` defaults to ``.table_cache/`` in
the checkout, as in bench.py:29-30::

    python -m mcsas_tpu_torch.tools.bench [--trace=DIR] [--no-certify]
    python -m mcsas_tpu_torch.tools.bench --suite [--only=sphere,...]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import traceback

from . import roofline, suite

_REPO = pathlib.Path(__file__).resolve().parents[2]
_TESTDATA = _REPO / "testdata"
REFERENCE_SECONDS = 36.0       # the reference's quickstart, bench.py:24
METRIC = ("wall-clock 10-rep sphere full fit() to chi2<=1 (MC + f64 post + "
          "histograms; sasfit_sphere-10-1, 300 contribs)")
_NM = 1e-9
# the drive audit's tiers that bench.py certifies (tools/drive_audit.py:
# 42-69; bench.py:356-357): (name, data, model, active, ranges, K, local
# moves)
CERTIFY = {entry[0]: entry for entry in (
    ("sphere", "sasfit_sphere-10-1.dat", "Sphere", None, None, 128, 0.5),
    ("kholodenko-worm", "sasfit_kho-1-10-1000.dat", "Kholodenko", None,
     None, 128, 0.75),
    ("cylinders-isotropic", "synth:cylinder", "CylindersIsotropic",
     ("radius",), {"radius": (0.5 * _NM, 300 * _NM)}, 128, 0.0),
)}
CERTIFY_SHARDED = ("sphere", "kholodenko-worm")
CERTIFY_SHARDS = 2


# ----------------------------------------------------------- the suite

def suite_row(name: str, device="cuda", **overrides) -> dict:
    """bench.py's suite line of the row *name* (bench.py:223-243): a cold
    ``fit()``, then a warm one, on *device*; *overrides* go on top of the
    row's config (the CPU tests shrink it)."""
    from ..api import fit
    row = suite.BENCH_ROWS[name]
    data = row.load()
    bound = row.bound(data)
    cfg = row.config(**overrides)
    _, cold = roofline.synced_wall(
        lambda: fit(data, bound, cfg, device=device), device)
    roofline.reset_launches()
    res, warm = roofline.synced_wall(
        lambda: fit(data, bound, cfg, device=device), device)
    e = res.engine
    return {
        "config": name, "model": row.model,
        "chi2_target": cfg.convergence_criterion,
        "seconds_warm": warm, "seconds_cold": cold,
        "max_chi2": float(e.conval.max()),
        "converged_reps": int(e.converged.sum()),
        "proposals_per_sec": e.iters_per_sec,
        "total_iters": int(e.total_iters),
        "pallas": bool(e.used_pallas), "table": bool(e.used_table),
        "local_moves": cfg.local_moves,
        "device": roofline.device_line(device),
        "launches": roofline.launches()}


# ------------------------------------------------------------- certify

def certify_workload(name: str, **overrides):
    """(data, bound, cfg) of the certify tier *name*: the drive audit's
    config (tools/drive_audit.py:55-69: 24 M proposals, chunks of 1024,
    seed 2026, no retry), *overrides* on top."""
    from ..config import McSASConfig
    from ..models import get_model
    _, path, model, active, ranges, k_cand, local = CERTIFY[name]
    data = suite.load_data(path)
    bound = get_model(model).bind(active=active, active_ranges=ranges)
    base = dict(num_contribs=300, num_reps=10, max_iterations=24_000_000,
                chunk_steps=1024, candidates_per_step=k_cand, seed=2026,
                max_retries=0, local_moves=local, show_incomplete=True)
    base.update(overrides)
    return data, bound, McSASConfig(**base)


def _counted_run(eng):
    roofline.reset_launches()
    res = eng.run()
    return res, roofline.launches()


def _inflation(a, b) -> float:
    return float(a.total_iters) / max(float(b.total_iters), 1.0)


def certify_tier(data, bound, cfg, device="cuda"):
    """Two runs of one seed on one engine: (the row, the first run)."""
    import numpy as np

    from ..core.engine import McSASEngine
    eng = McSASEngine(data, bound, cfg, device=device)
    first, l1 = _counted_run(eng)
    second, l2 = _counted_run(eng)
    row = {"n_iter_equal": bool(np.array_equal(first.n_iter,
                                               second.n_iter)),
           "inflation": _inflation(second, first),
           "pallas": bool(eng.runs_cuda_kernel),
           "prefetch": bool(eng.runs_cuda_kernel and eng.runs_prefetch),
           "table": bool(eng.uses_table),
           "launches": [l1, l2],
           "total_iters": int(first.total_iters)}
    if not row["n_iter_equal"]:
        row["n_iter"] = [first.n_iter.tolist(), second.n_iter.tolist()]
    return row, first


def certify_sharded(data, bound, cfg, base, device="cuda"):
    """A ShardedEnsemble of CERTIFY_SHARDS repetition shards on *device*
    against the unsharded run *base*: the row."""
    import numpy as np
    import torch

    from ..parallel import ShardedEnsemble, make_mesh
    dev = torch.device(device)
    se = ShardedEnsemble(data, bound, cfg, mesh=make_mesh(
        (CERTIFY_SHARDS, 1), [dev] * CERTIFY_SHARDS))
    res, counts = _counted_run(se)
    row = {"n_iter_equal": bool(np.array_equal(res.n_iter, base.n_iter)),
           "contribs_equal": bool(np.array_equal(res.contribs,
                                                 base.contribs)),
           "inflation": _inflation(res, base),
           "pallas_shard": bool(se.runs_cuda_kernel
                                and not se.runs_prefetch),
           "prefetch_shard": bool(se.runs_cuda_kernel and se.runs_prefetch),
           "mesh_platform": se.mesh.devices[0].type,
           "shards": CERTIFY_SHARDS,
           "launches_per_shard": {k: v / CERTIFY_SHARDS
                                  for k, v in counts.items()}}
    if not row["n_iter_equal"]:
        row["n_iter"] = [res.n_iter.tolist(), base.n_iter.tolist()]
    return row


def _error(e: Exception) -> dict:
    """A certify row that raised: its traceback to stderr, its error into
    the line."""
    traceback.print_exception(e, file=sys.stderr)
    return {"error": f"{type(e).__name__}: {e}"[:300]}


def certify(device="cuda", **overrides) -> dict:
    """{row name: row} of every certify tier and its sharded leg on
    *device*, *overrides* on top of their configs; a row that raised
    holds its ``error`` instead."""
    cert = {}
    for name in CERTIFY:
        try:
            workload = certify_workload(name, **overrides)
            cert[name], base = certify_tier(*workload, device=device)
        except Exception as e:  # recorded: the headline must survive
            cert[name] = _error(e)
            continue
        if name in CERTIFY_SHARDED:
            # a sharded failure must not clobber the tier's row above
            try:
                cert[name + "+sharded"] = certify_sharded(
                    *workload, base, device=device)
            except Exception as e:
                cert[name + "+sharded"] = _error(e)
    return cert


def certify_failures(cert: dict) -> list:
    """The names of the rows of *cert* that fail: an error, unequal
    counters or contributions, or an inflation other than 1.0."""
    return [name for name, row in cert.items()
            if "error" in row or not row["n_iter_equal"]
            or row["inflation"] != 1.0
            or not row.get("contribs_equal", True)]


# ----------------------------------------------------------- the headline

def _best_of_two(fn, device):
    """(the result of the faster of two synchronized calls, its seconds,
    the launches it counted)."""
    best = (None, float("inf"), None)
    for _ in range(2):
        roofline.reset_launches()
        out, dt = roofline.synced_wall(fn, device)
        if dt < best[1]:
            best = (out, dt, roofline.launches())
    return best


def headline(trace_dir=None, with_certify=True, device="cuda",
             **overrides) -> dict:
    """bench.py's main() on *device* (see the module's docstring),
    *overrides* on top of the headline's and certify's configs (the CPU
    tests shrink them)."""
    from ..api import fit
    from ..core.engine import McSASEngine
    from ..data import load
    from ..models import get_model
    from ..utils import profiling
    data, bound, cfg = roofline.headline_workload(**overrides)
    eng = McSASEngine(data, bound, cfg, device=device)
    eng.run()                                               # warm-up
    if trace_dir:
        with profiling.trace(trace_dir):
            eng.run()
        print(json.dumps({"trace": trace_dir}), file=sys.stderr)
    res, mc_s, _ = _best_of_two(eng.run, device)

    def full_fit():
        return fit(data, bound, cfg, device=device)
    full_fit()                                              # warm-up
    full, full_s, counts = _best_of_two(full_fit, device)

    qdata = load(_TESTDATA / "quickstartdemo1.csv")
    qbound = get_model("Sphere").bind(
        active_ranges={"radius": qdata.spherical_size_estimate})

    def quick_fit():
        return fit(qdata, qbound, cfg, device=device)
    quick_fit()                                             # warm-up
    qfit, quickstart_s, _ = _best_of_two(quick_fit, device)

    converged = bool(res.converged.all()) and full.converged
    out = {
        "metric": METRIC, "value": full_s if converged else -1.0,
        "unit": "s",
        "vs_baseline": REFERENCE_SECONDS / full_s if converged else 0.0,
        "mc_s": mc_s,
        "vs_baseline_mc": REFERENCE_SECONDS / mc_s if converged else 0.0,
        "proposals_per_sec": res.iters_per_sec,
        "converged_reps": int(res.converged.sum()),
        "max_chi2": float(res.conval.max()),
        "device": roofline.device_line(device),
        "launches": counts,
        "total_iters": int(res.total_iters)}
    if qfit.converged:
        out["quickstart_s"] = quickstart_s
        out["vs_baseline_quickstart"] = REFERENCE_SECONDS / quickstart_s
    if with_certify:
        out["certify"] = certify(device, **overrides)
    return out


# -------------------------------------------------------------- the CLI

def row_names(text: str) -> list:
    names = [n for n in text.split(",") if n]
    bad = sorted(set(names) - set(suite.BENCH_ROWS))
    if bad:
        raise argparse.ArgumentTypeError(
            f"unknown suite row(s) {bad}; choose from "
            f"{list(suite.BENCH_ROWS)}")
    return names


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mcsas_tpu_torch.tools.bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--suite", action="store_true",
                    help="bench.py's nine suite rows, one line each")
    ap.add_argument("--only", type=row_names, action="extend", default=None,
                    help="with --suite: comma-separated rows (repeatable)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one run() here")
    ap.add_argument("--no-certify", action="store_true",
                    help="skip the certification rows of the headline")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print(json.dumps({
            "metric": METRIC, "value": -1.0, "unit": "s",
            "vs_baseline": 0.0,
            "error": "no CUDA device: torch.cuda.is_available() is False; "
                     "the bench measures the card and never times the "
                     "CPU"}), flush=True)
        return 1
    os.environ.setdefault("MCSAS_TPU_TABLE_CACHE_DIR",
                          str(_REPO / ".table_cache"))
    if args.suite:
        for name in suite.BENCH_ROWS:
            if args.only is None or name in args.only:
                print(json.dumps(suite_row(name)), flush=True)
        return 0
    out = headline(args.trace, not args.no_certify)
    print(json.dumps(out), flush=True)
    return 1 if certify_failures(out.get("certify", {})) else 0


if __name__ == "__main__":
    sys.exit(main())
