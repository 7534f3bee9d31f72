# -*- coding: utf-8 -*-
"""Cold start of a new process on the card, split by stage, per tier.

The counterpart of the JAX package's tools/coldstart.py (which counts the
XLA executables a first fit compiles).  For each tier it runs one fresh
``python -c`` child, one at a time, and the child prints one JSON line
of host-clock stages, each ended by a synchronized card:

* ``import_s``: ``import torch`` and ``import mcsas_tpu_torch``;
* ``context_s``: CUDA context creation (the first tensor on the card);
* ``setup_s``: engine construction (magnitude probe; on the table tier
  the bake, or its load from MCSAS_TPU_TABLE_CACHE_DIR: ``table_cache_hit``);
* ``nvcc_s``: nvcc's seconds for the library of the kernel the tier's
  chunks launch (``KernelBuild.seconds``: 0.0 when build/kernels/ held
  it already) and ``load_s``, its load;
* ``prewarm_s`` (with ``--prewarm``): ``engine.prewarm()`` and
  ``api.prewarm_post``; ``prewarm_timings`` is prewarm's dict (nvcc and
  the load are then its entries, not stages of their own);
* ``first_fit_s`` and ``warm_fit_s``: the first ``fit()`` on the engine
  and its repeat (``first_fit_engine_s``: the first fit's MC loop, the
  rest is its float64 post pass);

plus the K1 and K2 launches of the first fit, the converged count and the
card's name and power limit.  The parent adds ``process_s``, the child's
wall from the start of its interpreter.  Without --prewarm the first fit
pays the kernel's lazy load, the first launches of the init and the
float64 post pass; with it, those are in ``prewarm_s``.  Needs a card
(it exits with an error naming it otherwise):

    python -m mcsas_tpu_torch.tools.coldstart [--tier=sphere ...] [--prewarm]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

_REPO = pathlib.Path(__file__).resolve().parents[2]
_TESTDATA = _REPO / "testdata"
TIERS = ("sphere", "gaussian-chain", "cylinders-table", "kholodenko-table")

# the child: the import is its first stage, so it is timed before
# anything of the package is imported
_CHILD = """\
import sys, time
t0 = time.perf_counter()
import torch
import mcsas_tpu_torch
import_s = time.perf_counter() - t0
from mcsas_tpu_torch.tools.coldstart import run_child
run_child(sys.argv[1], sys.argv[2] == "1", import_s)
"""


def tier_workload(tier: str):
    """(data, bound, cfg) of *tier*: the JAX tool's four tiers at its
    configs (300 contributions x 10 repetitions, K=128, seed 2026), the
    bound resolved as ``fit()`` resolves it."""
    from ..api import _default_unbounded_ranges
    from ..config import McSASConfig
    from ..data import load
    from ..models import get_model
    from . import suite
    kw = dict(num_contribs=300, num_reps=10, max_iterations=8_000_000,
              chunk_steps=2048, candidates_per_step=128, seed=2026,
              max_retries=1, show_incomplete=True)
    if tier == "sphere":
        data = load(_TESTDATA / "sasfit_sphere-10-1.dat")
        bound = get_model("Sphere").bind()
        kw.update(local_moves=0.5)
    elif tier == "gaussian-chain":
        data = load(_TESTDATA / "sasfit_gauss2-5-1.5-2-1.dat")
        bound = get_model("GaussianChain").bind()
        kw.update(candidates_per_step=64, max_iterations=4_000_000)
    elif tier == "cylinders-table":
        data = suite.cylinder_golden()
        bound = suite.cylinder_bound()
        kw.update(chunk_steps=1024)
    elif tier == "kholodenko-table":
        data = load(_TESTDATA / "sasfit_kho-1-10-1000.dat")
        bound = get_model("Kholodenko").bind()
        kw.update(local_moves=0.75, max_iterations=24_000_000)
    else:
        raise ValueError(f"unknown tier {tier!r}; one of {TIERS}")
    return data, _default_unbounded_ranges(bound, data), McSASConfig(**kw)


def _table_files() -> int:
    d = os.environ.get("MCSAS_TPU_TABLE_CACHE_DIR", "")
    return len(list(pathlib.Path(d).glob("table-*.npz"))) if d else 0


def run_child(tier: str, prewarm: bool, import_s: float) -> dict:
    """The child's stages (see the module's docstring); prints them as
    one JSON line and returns them."""
    import torch

    from .. import api
    from ..core.engine import McSASEngine
    from ..ops import cuda_lib, mc_kernel
    from ..utils.profiling import card_line, require_card
    require_card("coldstart")
    out = dict(tier=tier, prewarm=prewarm, import_s=import_s)

    def stage(name, fn):
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return value

    stage("context_s", lambda: torch.zeros(1, device="cuda"))
    data, bound, cfg = tier_workload(tier)
    tables_before = _table_files()
    eng = stage("setup_s", lambda: api._cached_engine(
        McSASEngine, data, bound, cfg, "cuda"))
    out["table"] = eng.uses_table
    out["table_cache_hit"] = (eng.uses_table and tables_before > 0
                              and _table_files() == tables_before)
    lib = "mc_prefetch" if eng.runs_prefetch else "mc_chunk"
    if prewarm:
        def warm():
            timings = eng.prewarm()
            api.prewarm_post(data, bound, cfg, device=eng.device)
            return timings
        timings = stage("prewarm_s", warm)
        out["prewarm_timings"] = timings
        out["nvcc_s"] = {lib: timings[f"nvcc {lib}"]}
        out["load_s"] = timings[f"load {lib}"]
    else:
        out["nvcc_s"] = {lib: cuda_lib.build_libraries((lib,))[lib].seconds}
        stage("load_s", lambda: cuda_lib.load(lib))
    k2 = (mc_kernel.run_prefetch_table_chunk, mc_kernel.run_prefetch_chunk)
    for fn in (mc_kernel.run_chunk, *k2):
        fn.launches = 0
    res = stage("first_fit_s", lambda: api.fit(data, bound, cfg,
                                               device="cuda"))
    if len(api._ENGINE_CACHE) != 1:
        raise AssertionError("the first fit built an engine of its own")
    out["k1_launches"] = mc_kernel.run_chunk.launches
    out["k2_launches"] = sum(fn.launches for fn in k2)
    out["first_fit_engine_s"] = res.engine.elapsed
    out["converged"] = int(res.engine.converged.sum())
    out["total_iters"] = res.engine.total_iters
    stage("warm_fit_s", lambda: api.fit(data, bound, cfg, device="cuda"))
    out["card"] = card_line()
    print(json.dumps(out), flush=True)
    return out


def run_tier(tier: str, prewarm: bool = False) -> dict:
    """Runs *tier* in a fresh child process; returns its JSON line with
    ``process_s`` and ``rc`` (and the tail of its errors where rc != 0)."""
    env = dict(os.environ)
    env.setdefault("MCSAS_TPU_TABLE_CACHE_DIR", str(_REPO / ".table_cache"))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO), env.get("PYTHONPATH", "")) if p)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _CHILD, tier,
                        str(int(prewarm))], capture_output=True, text=True,
                       cwd=_REPO, timeout=1800, env=env)
    wall = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    out = dict(json.loads(lines[-1]) if lines else {"tier": tier},
               process_s=wall, rc=r.returncode)
    if r.returncode != 0:
        out["stderr_tail"] = r.stderr[-2000:]
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mcsas_tpu_torch.tools.coldstart",
        description=__doc__.split("\n")[0])
    ap.add_argument("--tier", action="append", choices=TIERS,
                    help="a tier (repeatable); default: all four")
    ap.add_argument("--prewarm", action="store_true",
                    help="prewarm the engine and the post pass before the "
                         "first fit (fit(..., prewarm=True)'s work)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.profiling import require_card
    require_card("coldstart")
    failed = 0
    for tier in args.tier or TIERS:
        row = run_tier(tier, args.prewarm)
        print(json.dumps(row), flush=True)
        failed += row["rc"] != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
