# -*- coding: utf-8 -*-
"""Latency probe of the CUDA chunk kernels K1 and K2: where a step's
time goes.

The Hopper counterpart of the JAX package's tools/kern_probe.py.  Each
rung runs K1's real step loop (csrc/mc_chunk.cuh) cut short, in the
probe kernel K3 (csrc/mc_probe.cu):

  loop       cursor, activity check, ft − bank[ri], barriers
  rng        + the K proposals (Philox, or read injected) and local moves
  ff         + the K candidate rows over q, into registers
  solve      + float64 sums, closed-form solve, residual pass, best-of-K
  solve_mom  solve with χ² from the moments already summed instead of
             the residual pass: that idea's ceiling, never production
  full       + accept and state writes: K1 itself

For each model with a K1 device function, on the data of its suite row
(Sphere: the headline dataset) at the headline shape R=10, N=300, K=128,
local moves 0.5, each rung times LAUNCHES launches of CHUNK steps from
one state with CUDA events, at K1's own group width and, for the ff and
solve rungs, at every width of ``mc_kernel.PROBE_GROUPS`` too, and
prints one JSON line ``{"level", "model", "group", "threads",
"k1_shape", "us_per_step", "ms_per_launch"}`` (``k1_shape``: the rung
runs at K1's own group width).

K2's step loop (csrc/mc_prefetch.cuh) is cut the same way, for its
rows-in and its table-in entry, on the cylinder suite row (R=10, N=300,
K=128, Nq=100, a 4096-row table; criterion 0), for the table-in entry
with the intensity row on the slit-smeared row 'cylinders-smeared'
(entry ``intensity``: its table holds smeared intensities), and for the
table-in entry on the worm's row 'kholodenko-worm' (a 256 × 48 table
over lenKuhn and lenContour, no local moves) with the cross-section of
each point (entry ``factor``) and, for comparison, the same table blended
without it (entry ``blend``: the factor's cost is the difference):

  loop       cursor, activity check, ft − bank[ri], barriers
  rows       + the K rows into registers: staged a step ahead and read
             from shared memory (rows in), or blended from the table
  solve      + float64 sums, closed-form solve, residual pass, best-of-K
  full       + accept and state writes: K2 itself

Each rung times LAUNCHES launches of K2_STEPS steps (two of the fit's
131-step segments) and prints ``{"kernel": "K2", "entry", "level",
"model", "group", "threads", "source", "us_per_step",
"ms_per_launch"}``.  Needs a card:

    python -m mcsas_tpu_torch.tools.kern_probe [--steps N] [--launches N]
        [--model NAME] [--k2-steps N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib

import torch

from ..config import McSASConfig
from ..core.engine import McSASEngine
from ..data import load
from ..models import get_model
from ..ops import mc_kernel, tables
from .suite import (ROWS, TABLE_ROWS, cylinder_bound, cylinder_config,
                    cylinder_golden, cylinder_smeared_golden)

CHUNK = 2048
K2_STEPS = 262
K2_MODEL = "CylindersIsotropic"
K2_ENTRIES = ("rows", "table", "intensity", "factor", "blend")
LAUNCHES = 8
SEED = 20261016
_SPHERE_DATA = (pathlib.Path(__file__).resolve().parents[2] / "testdata"
                / "sasfit_sphere-10-1.dat")


def probe_engine(model_name: str, device="cuda") -> McSASEngine:
    """A headline-shaped engine (R=10, N=300, K=128, local moves 0.5) of
    *model_name* on its suite row's data and active set.  Its
    convergence criterion is 0, so that no repetition stops early and
    every rung runs all its steps."""
    cfg = McSASConfig(num_contribs=300, num_reps=10,
                      max_iterations=8_000_000, chunk_steps=CHUNK,
                      candidates_per_step=128, seed=2026, local_moves=0.5,
                      convergence_criterion=0.0)
    if model_name == "Sphere":
        data = load(_SPHERE_DATA)
        bound = get_model("Sphere").bind()
    else:
        row = next(r for r in ROWS.values() if r.model == model_name)
        data = row.load()
        bound = row.bound(data)
    return McSASEngine(data, bound, cfg, device=device)


def time_rung(eng: McSASEngine, state0, level: str, steps: int,
              launches: int, group: int = 0) -> float:
    """Mean ms of one *steps*-step launch of rung *level* at *group*
    lanes per candidate (0: K1's own; Philox mode) from *state0*, over
    *launches* launches after one warm-up, with CUDA events around all of
    them; the state is restored on the device before every launch (a
    ~1 MB copy)."""
    work = state0.clone()
    sinks = []

    def launch(i):
        sinks.append(mc_kernel.run_probe(work.copy_(state0), 0, eng.consts,
                                         eng.spec, level, seed=SEED + i,
                                         n_steps=steps, group=group)[2])

    ms = _time_launches(launch, launches)
    if any(s is not None and not torch.isfinite(s).all() for s in sinks):
        raise AssertionError(f"probe rung {level!r} left non-finite values")
    return ms


def run(models=None, steps: int = CHUNK, launches: int = LAUNCHES,
        levels=mc_kernel.PROBE_LEVELS, groups=mc_kernel.PROBE_GROUPS):
    """Probes each model's K1 at every rung, the ff and solve rungs also
    at each width of *groups*; returns the result dicts (one per rung,
    width and model) and prints each as a JSON line."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the CUDA kernel: "
                           "torch.cuda.is_available() is False")
    out = []
    for name in models or [m.name for m in mc_kernel.K1_MODELS]:
        eng = probe_engine(name)
        eng.gen.manual_seed(1)
        state0 = eng._init_batch()
        for level in levels:
            widths = (0, *groups) if level in ("ff", "solve") else (0,)
            for group in widths:
                ms = time_rung(eng, state0, level, steps, launches, group)
                shape = mc_kernel.launch_shape(state0, eng.consts, eng.spec,
                                               level, group)
                rec = {"level": level, "model": name,
                       "group": shape["group"], "threads": shape["threads"],
                       "k1_shape": group == 0,
                       "us_per_step": ms * 1e3 / steps, "ms_per_launch": ms}
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


def _time_launches(launch, launches: int) -> float:
    """Mean ms of ``launch(i)`` over *launches* runs after one warm-up,
    with CUDA events around all of them."""
    launch(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(launches):
        launch(i + 1)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / launches


def prefetch_probe_engine(entry: str):
    """The engine of a K2 probe entry (:data:`K2_ENTRIES`), criterion 0,
    and the spec its rungs run: the engine's own, or for ``blend`` the
    worm's table behind a plain lookup (no factor)."""
    if entry in ("factor", "blend"):
        row = TABLE_ROWS["kholodenko-worm"]
        data = row.load()
        eng = McSASEngine(data, row.bound(data),
                          row.config(convergence_criterion=0.0,
                                     local_moves=0.0), device="cuda")
    else:
        golden = (cylinder_smeared_golden() if entry == "intensity"
                  else cylinder_golden())
        eng = McSASEngine(golden, cylinder_bound(),
                          cylinder_config(convergence_criterion=0.0),
                          device="cuda")
    spec = eng.spec
    if entry == "blend":
        kern = dataclasses.replace(eng.kern, table_fn=tables.make_lookup(
            eng.kern.table_fn.tab_params))
        spec = dataclasses.replace(spec, kern=kern)
    return eng, spec


def run_prefetch(steps: int = K2_STEPS, launches: int = LAUNCHES,
                 levels=mc_kernel.PREFETCH_PROBE_LEVELS,
                 entries=K2_ENTRIES):
    """Probes K2 at every rung of both entries on the cylinder suite row,
    of the table entry on the smeared row (``intensity``) and on the
    worm's row with and without its cross-section (``factor``,
    ``blend``), criterion 0, so that every repetition runs all its steps;
    returns the result dicts and prints each as a JSON line.  Each launch
    starts from one state, restored on the device before it (a ~1 MB
    copy)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the CUDA kernel: "
                           "torch.cuda.is_available() is False")
    out = []
    for entry in entries:
        eng, spec = prefetch_probe_engine(entry)
        eng.gen.manual_seed(1)
        state0 = eng._init_batch()
        work = state0.clone()
        cands = eng._draw_chunk_proposals(steps)
        rows = eng.kern.row(cands) if entry == "rows" else None
        sw = mc_kernel.table_factors(spec, cands) if rows is None \
            else None
        for level in levels:
            sinks = []

            def launch(_):
                sinks.append(mc_kernel.run_prefetch_probe(
                    work.copy_(state0), 0, eng.consts, spec, level,
                    cands, rows, sw)[2])

            ms = _time_launches(launch, launches)
            if any(s is not None and not torch.isfinite(s).all()
                   for s in sinks):
                raise AssertionError(f"K2 probe rung {level!r} left "
                                     "non-finite values")
            shape = mc_kernel.prefetch_launch_shape(
                state0, eng.consts, spec, cands, rows, level)
            rec = {"kernel": "K2", "entry": entry, "level": level,
                   "model": eng.bound.model.name, "group": shape["group"],
                   "threads": shape["threads"], "source": shape["source"],
                   "us_per_step": ms * 1e3 / steps, "ms_per_launch": ms}
            print(json.dumps(rec), flush=True)
            out.append(rec)
        del rows
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=CHUNK)
    ap.add_argument("--launches", type=int, default=LAUNCHES)
    ap.add_argument("--model", action="append",
                    help="a model name (repeatable): a K1 model, or "
                         f"{K2_MODEL} for K2's rungs (every entry, the "
                         "worm's too); default: all")
    ap.add_argument("--k2-steps", type=int, default=K2_STEPS)
    args = ap.parse_args(argv)
    k1_models = [m for m in args.model or [] if m != K2_MODEL]
    if k1_models or not args.model:
        run(k1_models or None, args.steps, args.launches)
    if not args.model or K2_MODEL in args.model:
        run_prefetch(args.k2_steps, args.launches)


if __name__ == "__main__":
    main()
