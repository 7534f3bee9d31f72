# -*- coding: utf-8 -*-
"""The MC chunk kernels: a whole chunk of accept/reject steps per launch.

Three kernels, the Hopper counterparts of the JAX package's Pallas
kernels (mcsas_tpu/ops/mc_kernel.py and tools/kern_probe.py):

* K1, the fused chunk (``build_chunk_fn``): proposals, candidate rows,
  solve and accept all in the kernel, for the elementwise models with a
  device function (:data:`K1_MODELS`).  Plain version
  :func:`chunk_reference`, kernel ``csrc/mc_chunk.cu`` (the step loop in
  ``csrc/mc_chunk.cuh``, the models in ``csrc/mc_models.cuh``), wrapper
  :func:`run_chunk`.
* K2, the prefetch chunk (``build_prefetch_chunk_fn``), for the
  parameter-table tier and for the elementwise models K1 has no device
  function for (a user's plugin): one segment's candidates (S, R, K, P)
  are drawn before the launch and the kernel runs the solve/accept
  sequence on them.  Two entries of one step loop
  (``csrc/mc_prefetch.cuh``, built from ``csrc/mc_prefetch.cu``): *rows
  in*, the TPU kernel's own contract, takes the candidates' rows (S, R,
  K, Nq) evaluated before the launch (plain version
  :func:`prefetch_reference`, wrapper
  :func:`run_prefetch_chunk`); *table in*, the fit path, takes the
  parameter table and a factor per candidate (:func:`table_factors`: √w,
  or w for the intensity table of a smeared fit) and blends each row in
  the kernel, with the lookup's factor of each point where it declares
  one (:data:`ROW_FACTORS`: the Kholodenko worm's cross-section; plain
  version :func:`prefetch_table_reference`, wrapper
  :func:`run_prefetch_table_chunk`).  :func:`prefetch_entry` says which
  entry an engine's segments launch: a table the kernel cannot blend,
  and an elementwise plugin, go through the rows-in entry, their rows
  evaluated before the launch (:func:`segment_rows`).
* K3, the latency probe (``tools/kern_probe.py::build``): K1's step cut
  short at a rung (:data:`PROBE_LEVELS`), its ``ff`` and ``solve`` rungs
  also at each group width of :data:`PROBE_GROUPS`, and K2's step cut at
  a rung of :data:`PREFETCH_PROBE_LEVELS`; ``csrc/mc_probe.cu``,
  wrappers :func:`run_probe` and :func:`run_prefetch_probe`, runner
  ``tools/kern_probe.py``.  No PyTorch function computes a cut step: a
  ``full`` rung is K1 or K2 and is held against it.

The plain versions are batched over (R, K, Nq) in the operation order of
the JAX scan path (mcsas_tpu/core/engine.py::McSASEngine._step) and share
:func:`_step`.  The CPU tests hold them against the JAX package, and each
kernel is held against its plain version on the card.  This module
declares the kernels' parameter structs and C entries; ``ops/cuda_lib.py``
builds, loads and launches them.  Each wrapper checks its arguments,
launches its kernel for CUDA tensors, runs the plain version for CPU
tensors, and counts kernel launches in ``<wrapper>.launches``
(``run_chunk.model_launches`` also by model name; K3's two wrappers
count in ``run_probe.launches``).

One chunk, per repetition: ft is rebuilt from the bank (float64 sum), then
every step takes K candidates for the slot at the shared cursor ri (the
last ``k_local`` as local moves around the slot's current value),
evaluates their rows, solves each candidate's scale/background with
float64 sums, picks the first minimum χ² (NaN counts as +inf), accepts it
iff the repetition is active and χ² improves, and advances ri mod N.

K1's proposals come either injected, as an (S, R, K, P) tensor in the JAX
contract (global columns in SI, local columns unit uniforms), or — kernel
only — from the in-kernel Philox4x32-10 stream described by
:func:`philox_proposals`.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.fitcore import FitConstants, solve_scale_bg
from ..core.rng import DECADES, local_candidates, range_vectors
from ..models.chains import GaussianChain
from ..models.ellipsoids import SphericalCoreShell
from ..models.sphere import LMADenseSphere, Sphere, lma_standoff
from ..utils import profiling
from . import cuda_lib

MAX_P = 8                      # active parameters the kernels take
MAX_MODEL_P = 8                # parameters of a K1 model, fixed included
# the models with a K1 device function, by model id (csrc/mc_models.cuh)
K1_MODELS = (Sphere, LMADenseSphere, GaussianChain, SphericalCoreShell)
# K3's rungs, in the order of MC_LV_* in csrc/mc_chunk.cuh
PROBE_LEVELS = ("loop", "rng", "ff", "solve", "solve_mom", "full")
# lanes per candidate K3's ff and solve rungs run at besides K1's own
PROBE_GROUPS = (8, 16, 32)
# K3's rungs of K2, in the order of MC2_LV_* in csrc/mc_prefetch.cuh
PREFETCH_PROBE_LEVELS = ("loop", "rows", "solve", "full")
# where K2 takes a candidate's row from (MC2_SRC_* in csrc/mc_prefetch.cuh)
PREFETCH_SOURCES = ("staged", "direct", "table", "table_ahead")
MAX_TABLE_AXES = 2             # table axes K2's table entry blends
# the factors a lookup may apply to its blend at each point and candidate
# that K2's table entry computes too (a lookup declares one as
# ``lookup.row_factor = (kind, parameter)``), by MC2_XS_* code of
# csrc/mc_prefetch.cuh: the worm's cross-section 2·j1_over_x(q·radius)
ROW_FACTORS = {"cross_section": 1}
# the JAX package's HBM cap for one prefetch segment's staged candidate
# rows (its _PREFETCH_HBM_BUDGET), kept for the segment length it gives
PREFETCH_ROW_BYTES = 64 * 2 ** 20
# float32 values of one temporary of the eager lookup of a table wider
# than the fit grid (segment_rows, 4 MiB): the smeared worm's lookup keeps
# about 17 alive, so a block works in about PREFETCH_ROW_BYTES beside the
# segment's rows
ROWS_BLOCK_VALUES = PREFETCH_ROW_BYTES // 64
_GEN_CODES = {"uniform": 0, "logdec1": 1, "logdec2": 2, "logdec3": 3}


@dataclass(frozen=True)
class ChunkSpec:
    """Static description of one engine's chunk: everything but the state.

    ``kern`` is the engine's ``IntensityKernel``: the plain version calls
    its ``row``; the kernel computes the same row from the model id, the
    fit grid and the row scalars."""
    model: object
    kern: object
    n_contribs: int
    k_cand: int
    k_local: int
    local_scale: float
    crit: float
    max_iter: int
    find_bg: bool
    pos_bg: bool
    ranges: tuple
    generators: tuple

    @property
    def k_global(self) -> int:
        return self.k_cand - self.k_local

    def bounds(self, dtype, device):
        """(lo, hi) active-range vectors as tensors, built once per dtype
        and device (``rng.range_vectors``): a copy from the host waits for
        the card's stream, and a segment is issued while the previous one
        runs."""
        key = (dtype, torch.device(device))
        if key not in self._bounds:
            self._bounds[key] = range_vectors(self.ranges, dtype, device)
        return self._bounds[key]

    @functools.cached_property
    def _bounds(self) -> dict:
        return {}

    @functools.cached_property
    def model_layout(self):
        """What K1 needs to rebuild ``BoundModel.pdict`` per candidate:
        ``(pfix, pcol, sw_fixed)``.  For each model parameter in
        declaration order, ``pcol`` is its active column or -1 and
        ``pfix`` its fixed value (float64).  LMADenseSphere's automatic
        standoff (mf = -1) with a fixed volume fraction is folded here, as
        the plain version computes it in Python.  ``sw_fixed`` is √w as
        the rows use it when the volume depends on no active parameter
        (w a Python float, rounded to float32, then the float32 square
        root), else None."""
        bound = self.kern.bound
        fixed = dict(bound.fixed)
        if bound.model is LMADenseSphere and "volFrac" in fixed:
            fixed["mf"] = lma_standoff(fixed["mf"], fixed["volFrac"])
        names = bound.model.param_names
        pcol = tuple(bound.active.index(n) if n in bound.active else -1
                     for n in names)
        pfix = tuple(0.0 if n in bound.active else float(fixed[n])
                     for n in names)
        w = self.kern.weight(bound.pdict(
            torch.ones(bound.n_active, dtype=torch.float64)))
        sw = (None if isinstance(w, torch.Tensor)
              else float(np.sqrt(np.float32(w))))
        return pfix, pcol, sw

    @functools.cached_property
    def table_layout(self) -> tuple:
        """What K2's table entry needs to repeat ``lookup_param_table`` on
        the engine's table: for each table axis with more than one node,
        first axis first, ``(col, fixed, l0, dl, n, hi)`` — the active
        column that feeds it, or -1 and its fixed value; the log of its
        first node, its log spacing and the clamp's upper end
        ``n - 1.000001``, each rounded to float32 as the lookup's tensors
        round them.  Raises where :func:`table_blend_refusal` has a
        reason."""
        kern = self.kern
        refusal = table_blend_refusal(kern)
        if refusal:
            raise ValueError(refusal)
        names = kern.table_fn.tab_params
        bound, fixed = kern.bound, dict(kern.bound.fixed)
        f32 = lambda v: float(np.float32(v))    # noqa: E731
        axes = []
        for name, (l0, dl, n) in zip(names, kern.table.axes):
            if n == 1:
                continue
            col = bound.active.index(name) if name in bound.active else -1
            axes.append((col, 0.0 if col >= 0 else f32(fixed[name]),
                         f32(l0), f32(dl), int(n), f32(n - 1.000001)))
        return tuple(axes)

    @functools.cached_property
    def factor_layout(self) -> tuple:
        """The factor the table's lookup applies to its blend, as K2's
        table entry takes it: ``(code, col, fixed)`` — its MC2_XS_* code
        (:data:`ROW_FACTORS`, 0 for none), the active column of its
        parameter, or -1 and the parameter's fixed value.  Raises where
        :func:`table_blend_refusal` has a reason."""
        kern = self.kern
        refusal = table_blend_refusal(kern)
        if refusal:
            raise ValueError(refusal)
        factor = getattr(kern.table_fn, "row_factor", None)
        if factor is None:
            return (0, -1, 0.0)
        kind, name = factor
        bound = kern.bound
        if name in bound.active:
            return (ROW_FACTORS[kind], bound.active.index(name), 0.0)
        return (ROW_FACTORS[kind], -1, float(dict(bound.fixed)[name]))


def table_blend_refusal(kern) -> Optional[str]:
    """Why K2's table entry cannot blend the rows of *kern*'s table
    itself, or None when it can: it needs a parameter table, a lookup
    that names one parameter per table axis (``table_fn.tab_params``,
    ``tables.make_lookup``: any other lookup may do more than blend), at
    most :data:`MAX_TABLE_AXES` axes with more than one node, and, where
    the lookup declares a factor of its blend (``table_fn.row_factor``),
    one of :data:`ROW_FACTORS` on an amplitude table."""
    names = getattr(kern.table_fn, "tab_params", None)
    if kern.table is None or names is None:
        return ("K2's table entry needs a parameter table and a lookup "
                "made by tables.make_lookup")
    if len(names) != len(kern.table.axes):
        return (f"the lookup reads {len(names)} parameters, the table has "
                f"{len(kern.table.axes)} axes")
    n_axes = sum(n > 1 for _, _, n in kern.table.axes)
    if n_axes > MAX_TABLE_AXES:
        return (f"K2's table entry blends at most {MAX_TABLE_AXES} table "
                f"axes, this table has {n_axes}")
    factor = getattr(kern.table_fn, "row_factor", None)
    if factor is not None:
        kind, name = factor
        if kind not in ROW_FACTORS:
            return (f"K2's table entry knows the row factors "
                    f"{sorted(ROW_FACTORS)}, the lookup declares {kind!r}")
        if kern.table_is_intensity:
            return "K2's table entry applies a row factor to amplitudes only"
        if name not in kern.bound.model.param_names:
            return f"the row factor's parameter {name!r} is not the model's"
    return None


def has_device_function(model) -> bool:
    """True when K1 has a device function for this very model object
    (:data:`K1_MODELS`, by identity: a plugin registered under a
    built-in's name, even a field-for-field copy, has none)."""
    return any(model is m for m in K1_MODELS)


def model_id(model) -> int:
    """The kernel's integer id of a model (csrc/mc_models.cuh)."""
    for i, m in enumerate(K1_MODELS):
        if m is model:
            return i
    raise ValueError(f"the CUDA chunk kernel has no device function for "
                     f"model {getattr(model, 'name', model)!r} (K1 runs "
                     f"{', '.join(m.name for m in K1_MODELS)})")


def elementwise_eligible(engine) -> bool:
    """The JAX package's gate of its fused kernel K1
    (mcsas_tpu/ops/mc_kernel.py:38-44) on this engine: a model that
    declares ``elementwise_q``, 1D data, not smeared (where the model
    smears), float32, 1 ≤ P ≤ MAX_P, and no parameter table."""
    model = engine.bound.model
    return (model.elementwise_q
            and engine.kern.table is None
            and engine.kern.psi is None
            and not (engine.data.uses_smearing and model.can_smear)
            and engine.dtype == torch.float32
            and 1 <= engine.bound.n_active <= MAX_P)


def supports(engine) -> bool:
    """True when the fused kernel K1 can run this engine's configuration:
    the JAX package's gate (:func:`elementwise_eligible`) for the models
    with a device function (:data:`K1_MODELS`, by identity: a plugin
    registered under a built-in's name is not one)."""
    model = engine.bound.model
    return (has_device_function(model)
            and len(model.params) <= MAX_MODEL_P
            and elementwise_eligible(engine))


def prefetch_entry(engine) -> Optional[str]:
    """The entry of the prefetch kernel K2 that runs this engine's
    segments, or None where K2 cannot.  The parameter-table tier in
    float32 (local moves included — see :func:`segment_candidates`;
    smeared tables included): ``'table'`` where the kernel can blend the
    table's rows itself (:func:`table_blend_refusal`), else ``'rows'``:
    the rows are evaluated with the table's own lookup before the launch,
    which is the TPU kernel's contract and takes any table.  An
    elementwise model without a device function of K1 (a user's plugin
    that passes the JAX package's K1 gate, :func:`elementwise_eligible`):
    ``'rows'``, the rows evaluated by the model's own ``ff`` before the
    launch."""
    if engine.uses_table:
        if not (engine.dtype == torch.float32
                and 1 <= engine.bound.n_active <= MAX_P):
            return None
        return "rows" if table_blend_refusal(engine.kern) else "table"
    if elementwise_eligible(engine) and not supports(engine):
        return "rows"
    return None


def segment_rows(spec: ChunkSpec, cands: torch.Tensor) -> torch.Tensor:
    """The rows (S, R, K, Nq) of one segment's candidates (S, R, K, P)
    by the engine's own row (``spec.kern.row``: the table's lookup, or
    an elementwise model's ``ff`` on the fit grid).  A model's ``ff`` and
    a lookup whose table is Nq wide hold temporaries of the rows' own
    size, which the segment length already bounds (PREFETCH_ROW_BYTES):
    they run on the whole segment.  A wider lookup runs in blocks of
    steps of each repetition (the K candidates of one step and
    repetition stay together) whose temporaries hold about
    :data:`ROWS_BLOCK_VALUES` values each: the smeared worm's table is
    Nq·n_off wide (2,600 at Nq=100 with 26 offsets), and a whole 131-step
    segment at R=10, K=128 would make 1.7 GB temporaries, one step 13 MB,
    one step of one repetition 1.3 MB.  The engine's segment and the plain
    version evaluate the same blocks.  Rows that carry the lookup's row
    factor count in ``ops.mc_kernel.cross_section``
    (:func:`_count_row_factor`)."""
    kern = spec.kern
    _count_row_factor(kern)
    if kern.table is None:
        return kern.row(cands)
    width = kern.table.values.shape[1]
    flat = cands.reshape(-1, *cands.shape[2:])          # (S·R, K, P)
    block = max(1, ROWS_BLOCK_VALUES // (cands.shape[2] * width))
    if width <= kern.grid.numel() or block >= flat.shape[0]:
        return kern.row(cands)
    out = torch.empty((*flat.shape[:-1], kern.grid.numel()),
                      dtype=kern.grid.dtype, device=cands.device)
    for i in range(0, flat.shape[0], block):
        out[i:i + block] = kern.row(flat[i:i + block])
    return out.reshape(*cands.shape[:-1], -1)


def _count_row_factor(kern) -> None:
    """Adds one to ``ops.mc_kernel.cross_section`` under
    ``utils.profiling.recording()`` where a segment's rows carry the
    factor *kern*'s table lookup declares (``row_factor``, one of
    :data:`ROW_FACTORS`): a launch of K2's table entry that computes it,
    its plain version, or rows the lookup evaluates for a segment."""
    if (kern.table is not None
            and getattr(kern.table_fn, "row_factor", None) is not None):
        profiling.count("ops.mc_kernel.cross_section")


def supports_prefetch(engine) -> bool:
    """True when the prefetch kernel K2 can run this engine, through
    either entry (:func:`prefetch_entry`)."""
    return prefetch_entry(engine) is not None


def prefetch_seg_steps(engine) -> int:
    """Steps per prefetch segment: bounded by the configured chunk size
    and by the JAX package's cap on a segment's (S, R, K, Nq) rows; with
    local moves also by ``num_contribs``, so that a segment visits
    distinct slots (the JAX package's rule, without its lane padding).
    The table entry stages no rows (it blends them in the kernel): there
    the cap is the JAX package's segment length, kept so that a fit draws
    the same proposals and takes the same decisions.  On the rows-in
    entry (an elementwise plugin, a table the kernel cannot blend) the
    rows are staged, and the cap is their memory budget."""
    cfg = engine.cfg
    per_step = (int(cfg.num_reps) * int(cfg.candidates_per_step)
                * int(engine.consts.n) * 4)
    cap = int(cfg.chunk_steps)
    if engine._k_local():
        cap = min(cap, int(cfg.num_contribs))
    return max(1, min(cap, PREFETCH_ROW_BYTES // max(per_step, 1)))


# ------------------------------------------------------ plain versions

_TRACE_KEYS = ("choice", "chi", "conval", "slot")


def _as_shards(state, *per_shard):
    """*state* and each of *per_shard* (constants, specs, rows) as lists
    of q shards: a state of the whole grid is one shard.  A q shard is a
    RepState whose ibank and ft hold its columns of the grid and whose
    other fields are copies of every other shard's; its FitConstants hold
    its columns of y and u, and its spec's kernel evaluates its columns
    of a row (``parallel.spmd``)."""
    if isinstance(state, (list, tuple)):
        return [list(state)] + [list(p) for p in per_shard]
    return [[state]] + [[p] for p in per_shard]


def _step(state, ri_s: int, consts, spec, cands: torch.Tensor, rows,
          trace: Optional[dict]):
    """One accept/reject step of every repetition at slot *ri_s*, on
    candidates (R, K, P) and their rows (R, K, Nq); state updated in
    place.  Shared by both plain versions.

    On q shards (lists of states, constants and rows, one per shard, as
    :func:`_as_shards` takes them; *spec* and *cands* are the first
    shard's) the solve's sums cross the shards
    (:func:`fitcore.solve_scale_bg`), the decision is made on the first
    shard's device and every shard applies it."""
    cells, cs, rs = _as_shards(state, consts, rows)
    home = cells[0]
    r_idx = torch.arange(home.rset.shape[0], device=home.rset.device)
    active = (home.conval > spec.crit) & (home.n_iter < spec.max_iter)
    olds = [c.ibank[:, ri_s, :] for c in cells]
    xs = [(c.ft - old)[:, None, :] + row
          for c, old, row in zip(cells, olds, rs)]
    one = len(cells) == 1          # the unsharded solve takes tensors
    sol = solve_scale_bg(xs[0] if one else xs, cs[0] if one else cs,
                         spec.find_bg, spec.pos_bg)
    chi = torch.where(torch.isnan(sol.chisqr),
                      torch.full_like(sol.chisqr, float("inf")),
                      sol.chisqr)
    best = torch.argmin(chi, dim=1)                           # first min
    best_chi = chi[r_idx, best]
    accept = active & (best_chi < home.conval)
    if trace is not None:
        trace["choice"].append(torch.where(accept, best.to(torch.int32), -1))
        trace["chi"].append(chi)
        trace["conval"].append(home.conval.clone())
    new_rset = cands[r_idx, best]
    new_scale = sol.scale[r_idx, best]
    new_bg = sol.background[r_idx, best]
    for c, old, x, row in zip(cells, olds, xs, rs):
        dev = c.rset.device
        acc_c, best_c = accept.to(dev), best.to(dev)
        r_c = r_idx.to(dev)
        acc = acc_c[:, None]
        c.rset[:, ri_s, :] = torch.where(acc, new_rset.to(dev),
                                         c.rset[:, ri_s, :])
        c.ibank[:, ri_s, :] = torch.where(acc, row[r_c, best_c], old)
        c.ft.copy_(torch.where(acc, x[r_c, best_c], c.ft))
        c.scale.copy_(torch.where(acc_c, new_scale.to(dev), c.scale))
        c.background.copy_(torch.where(acc_c, new_bg.to(dev),
                                       c.background))
        c.conval.copy_(torch.where(acc_c, best_chi.to(dev), c.conval))
        c.n_iter += spec.k_cand * active.to(dev).to(torch.int32)
        c.n_moves += acc_c.to(torch.int32)
    if trace is not None:
        trace["slot"].append(home.rset[:, ri_s, :].clone())


def _run_steps(state, ri: int, n_steps: int, step, trace: Optional[dict]):
    """Refreshes ft from the bank (float64 sum: bounds the float32 drift
    to one chunk), then runs ``step(s, slot)`` for s < n_steps; returns
    ``(state, cursor)``.  *state* may be a list of q shards, each refreshed
    from its own columns.  With a *trace* dict it also records, per step,
    the chosen candidate (``choice`` (S, R) int32, -1 where nothing was
    accepted), every candidate's χ² (``chi`` (S, R, K)), χ² before the
    step (``conval`` (S, R)) and the slot's parameters after it
    (``slot`` (S, R, P)) — what a comparison needs to find the first flip
    and judge a near-tie."""
    cells = state if isinstance(state, (list, tuple)) else [state]
    n = cells[0].rset.shape[1]
    if trace is not None:
        trace.update({key: [] for key in _TRACE_KEYS})
    for c in cells:
        c.ft.copy_(c.ibank.double().sum(dim=1))
    for s in range(n_steps):
        step(s, (ri + s) % n)
    if trace is not None:
        for key in _TRACE_KEYS:
            trace[key] = torch.stack(trace[key]) if trace[key] else None
    return state, (ri + n_steps) % n


def chunk_reference(state, ri: int, consts, spec, proposals: torch.Tensor,
                    trace: Optional[dict] = None):
    """Plain PyTorch version of K1: ``proposals.shape[0]`` steps, each
    turning its local columns into moves around the slot's current value
    and evaluating its rows; state updated in place.  Returns
    ``(state, cursor)``; *trace* as in :func:`_run_steps`.  On q shards
    (lists, :func:`_as_shards`) each shard evaluates its columns of the
    rows and :func:`_step` joins them; *proposals* lie on the first
    shard's device."""
    cells, cs, specs = _as_shards(state, consts, spec)
    home, spec0 = cells[0], specs[0]
    k_global = spec0.k_global
    lo, hi = spec0.bounds(home.rset.dtype, home.rset.device)

    def step(s, ri_s):
        cands = proposals[s]                                  # (R, K, P)
        if spec0.k_local:
            local = local_candidates(home.rset[:, ri_s, :],
                                     cands[:, k_global:, :], lo, hi,
                                     spec0.local_scale)
            cands = torch.cat([cands[:, :k_global, :], local], dim=1)
        rows = [sp.kern.row(cands.to(c.rset.device))
                for sp, c in zip(specs, cells)]
        _step(cells, ri_s, cs, spec0, cands, rows, trace)

    _run_steps(cells, ri, int(proposals.shape[0]), step, trace)
    return state, (ri + int(proposals.shape[0])) % home.rset.shape[1]


def prefetch_reference(state, ri: int, consts, spec, rows, cands,
                       trace: Optional[dict] = None):
    """Plain PyTorch version of K2: one segment of ``rows.shape[0]``
    steps on given candidates (S, R, K, P) and their rows (S, R, K, Nq);
    state updated in place.  Returns ``(state, cursor)``; *trace* as in
    :func:`_run_steps`.  On q shards (lists, :func:`_as_shards`) *rows*
    is a list of each shard's columns."""
    cells, cs, specs, rs = _as_shards(state, consts, spec, rows)

    def step(s, ri_s):
        _step(cells, ri_s, cs, specs[0], cands[s], [r[s] for r in rs],
              trace)

    _run_steps(cells, ri, int(cands.shape[0]), step, trace)
    return state, (ri + int(cands.shape[0])) % cells[0].rset.shape[1]


def prefetch_table_reference(state, ri: int, consts, spec,
                             cands: torch.Tensor,
                             trace: Optional[dict] = None):
    """Plain PyTorch version of K2's table entry: the candidates' rows
    from the engine's table lookup (``spec.kern.row``, in blocks of steps:
    :func:`segment_rows`), then :func:`prefetch_reference` on them; state
    updated in place.  Returns ``(state, cursor)``.  On q shards each
    shard looks up its columns.  A repetition shard of a table engine or
    of an elementwise plugin runs its plain segment here too (one q
    shard: :func:`prefetch_reference` on :func:`segment_rows`)."""
    cells, _, specs = _as_shards(state, consts, spec)
    rows = [segment_rows(sp, cands.to(c.rset.device))
            for sp, c in zip(specs, cells)]
    return prefetch_reference(state, ri, consts, spec,
                              rows if isinstance(state, (list, tuple))
                              else rows[0], cands, trace)


def _per_candidate(w: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """A weight of shape (S, R, K, 1), or 0-dim (a volume without an
    active parameter gives every candidate the same value), as a
    contiguous (S, R, K) tensor."""
    return w.expand(*cands.shape[:-1], 1).reshape(
        cands.shape[:-1]).contiguous()


def sqrt_weights(spec: ChunkSpec, cands: torch.Tensor) -> torch.Tensor:
    """√w of the candidates (S, R, K, P), contiguous (S, R, K): the
    engine's own ``IntensityKernel.sqrt_weight``, the factor K2's table
    entry takes for an amplitude table."""
    return _per_candidate(spec.kern.sqrt_weight(cands), cands)


class TableFactors(NamedTuple):
    """The per-candidate factors of K2's table entry and what they are:
    ``'sqrt_w'`` for an amplitude table (row = (blend·√w)²), ``'w'`` for
    an intensity table (row = blend·w)."""
    values: torch.Tensor                   # (S, R, K)
    kind: str


def table_factors(spec: ChunkSpec, cands: torch.Tensor) -> TableFactors:
    """What K2's table entry multiplies each candidate's blend by, with
    the rounding of ``IntensityKernel.row``: √w, or w itself where the
    table holds intensities (a smeared fit) — (√w)² is not w in float32,
    and the kernel is held to the row bit for bit."""
    if spec.kern.table_is_intensity:
        return TableFactors(
            _per_candidate(spec.kern.row_weight(cands), cands), "w")
    return TableFactors(sqrt_weights(spec, cands), "sqrt_w")


def segment_candidates(state, ri: int, spec: ChunkSpec,
                       proposals: torch.Tensor) -> torch.Tensor:
    """The candidates (S, R, K, P) of one prefetch segment starting at
    cursor *ri*: global columns as drawn, local columns (unit uniforms)
    turned into moves around each step's slot value at segment start.  A
    segment of at most N steps visits distinct slots, so that value is
    the slot's value at its step (JAX: mc_kernel.py:771-798)."""
    if not spec.k_local:
        return proposals
    n_steps, n = int(proposals.shape[0]), spec.n_contribs
    if n_steps > n:
        # a correctness precondition, not a debug check: second visits
        # would move around a stale segment-start value
        raise ValueError(f"local moves need distinct slots per segment: "
                         f"{n_steps} steps > num_contribs={n}")
    dev = state.rset.device
    slots = (ri + torch.arange(n_steps, device=dev)) % n
    cur = state.rset[:, slots, :].transpose(0, 1)             # (S, R, P)
    lo, hi = spec.bounds(state.rset.dtype, dev)
    k_global = spec.k_global
    local = local_candidates(cur, proposals[:, :, k_global:, :], lo, hi,
                             spec.local_scale)
    return torch.cat([proposals[:, :, :k_global, :], local],
                     dim=2).contiguous()


def decision_margin(chi: torch.Tensor, conval: torch.Tensor) -> torch.Tensor:
    """How close a step's decision was: the smaller of the relative gaps
    best-vs-current χ² and best-vs-next-larger candidate χ² (candidates
    equal to the best are the same proposal and cannot flip).  *chi* is
    (..., K), *conval* (...); a margin near float32 rounding (~1e-7) means
    another summation order may decide the step the other way."""
    chi = chi.double()
    best = chi.min(dim=-1).values
    above = torch.where(chi > best[..., None], chi,
                        torch.full_like(chi, float("inf")))
    second = above.min(dim=-1).values
    conv = conval.double()
    return torch.minimum(
        (best - conv).abs() / conv.abs().clamp_min(1e-300),
        (second - best).abs() / best.abs().clamp_min(1e-300))


# ------------------------------------------- the kernel's Philox stream

_PHILOX_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
_PHILOX_W = (np.uint32(0x9E3779B9), np.uint32(0xBB67AE85))
_MASK32 = np.uint64(0xFFFFFFFF)


def philox4x32(counter, key, rounds: int = 10) -> np.ndarray:
    """Philox4x32 (Salmon et al., SC'11) on the host, vectorized:
    *counter* (4, ...) and *key* (2, ...) uint32 → (4, ...) uint32.  The
    kernel's ``philox_x0`` computes word 0 of the same function."""
    c = [np.asarray(w, np.uint32) for w in counter]
    k0, k1 = (np.asarray(w, np.uint32) for w in key)
    with np.errstate(over="ignore"):
        for i in range(rounds):
            if i:
                k0 = k0 + _PHILOX_W[0]
                k1 = k1 + _PHILOX_W[1]
            p0 = _PHILOX_M[0] * c[0].astype(np.uint64)
            p1 = _PHILOX_M[1] * c[2].astype(np.uint64)
            hi0 = (p0 >> np.uint64(32)).astype(np.uint32)
            hi1 = (p1 >> np.uint64(32)).astype(np.uint32)
            lo0 = (p0 & _MASK32).astype(np.uint32)
            lo1 = (p1 & _MASK32).astype(np.uint32)
            c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return np.stack(c)


def philox_proposals(spec: ChunkSpec, seed: int, n_reps: int,
                     n_steps: int, device=None, rep_base: int = 0
                     ) -> np.ndarray:
    """The proposals the kernel draws in Philox mode, as an (S, R, K, P)
    float32 array in the injected contract, for the repetitions
    rep_base .. rep_base + n_reps - 1.

    Key (seed, rep_base + rep), counter (step, k, parameter, 0); the top
    24 bits of output word 0 make the unit uniform u.  Global columns become
    lo + g(u)·(hi − lo) with g the generator's transform
    (10^(u·N) − 1)/10^N for logdecN; local columns keep u.  The kernel
    takes 10^x with CUDA's powf: with a CUDA *device* the transform runs
    there (PyTorch's float32 pow on the card is that powf), which
    reproduces the stream bit for bit; numpy's powf on the host may
    differ from it in the last ulp."""
    k, p = spec.k_cand, len(spec.ranges)
    s_ix, r_ix, k_ix, p_ix = np.meshgrid(
        np.arange(n_steps), np.arange(n_reps), np.arange(k), np.arange(p),
        indexing="ij")
    zero = np.zeros_like(s_ix)
    bits = philox4x32((s_ix, k_ix, p_ix, zero),
                      (np.full_like(s_ix, seed & 0xFFFFFFFF),
                       r_ix + rep_base))[0]
    u = (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    out = u.copy()
    for ip, (g, (lo, hi)) in enumerate(zip(spec.generators, spec.ranges)):
        ug = u[..., :spec.k_global, ip]
        if g in DECADES:
            x = ug * np.float32(DECADES[g])
            top = np.float32(10.0 ** DECADES[g])
            if device is None:
                ug = (np.float32(10.0) ** x - np.float32(1.0)) / top
            else:
                xt = torch.as_tensor(x, device=device)
                p10 = torch.pow(torch.full_like(xt, 10.0), xt)
                ug = torch.div(p10 - 1.0,
                               torch.full_like(xt, float(top))).cpu().numpy()
        lo32, hi32 = np.float32(lo), np.float32(hi)
        out[..., :spec.k_global, ip] = ug * (hi32 - lo32) + lo32
    return out


# ------------------------------------------ parameter structs and entries

# the state's pointer fields of K1's and K2's structs, in their order
_STATE_PTRS = ("rset", "ibank", "ft", "scale", "background", "conval",
               "n_iter", "n_moves")


class _ChunkParams(ctypes.Structure):
    """Mirror of ``ChunkParams`` in csrc/mc_chunk.cuh (same field
    order)."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "q", "y", "u", *_STATE_PTRS, "sink", "proposals", "trace")]
        + [(name, ctypes.c_double) for name in ("s_u", "s_uy", "comp2")]
        + [("pfix", ctypes.c_double * MAX_MODEL_P),
           ("lo", ctypes.c_float * MAX_P), ("hi", ctypes.c_float * MAX_P)]
        + [(name, ctypes.c_float) for name in (
            "crit", "local_scale", "inv_v_ref", "inv_i_ref", "row_clamp",
            "sw_fixed")]
        + [("gen", ctypes.c_int32 * MAX_P),
           ("pcol", ctypes.c_int32 * MAX_MODEL_P)]
        + [(name, ctypes.c_int32) for name in (
            "n_reps", "n_contribs", "nq", "n_params", "n_model_params",
            "k_cand", "k_global", "n_steps", "ri0", "max_iter", "n_fit",
            "model_id", "vol_fixed", "find_bg", "pos_bg", "device",
            "rep_base")]
        + [("seed", ctypes.c_uint32)])


class _PrefetchParams(ctypes.Structure):
    """Mirror of ``PrefetchParams`` in csrc/mc_prefetch.cuh (same field
    order)."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "q", "y", "u", *_STATE_PTRS, "rows", "cands", "table", "sw",
            "sink", "trace")]
        + [("s_u", ctypes.c_double), ("s_uy", ctypes.c_double),
           ("crit", ctypes.c_float), ("row_clamp", ctypes.c_float),
           ("xs_fixed", ctypes.c_float)]
        + [(name, ctypes.c_float * MAX_TABLE_AXES) for name in (
            "ax_l0", "ax_dl", "ax_hi", "ax_fixed")]
        + [(name, ctypes.c_int32 * MAX_TABLE_AXES) for name in (
            "ax_n", "ax_col")]
        + [(name, ctypes.c_int32) for name in (
            "n_axes", "n_table_rows", "n_reps", "n_contribs", "nq",
            "n_params", "k_cand", "n_steps", "ri0", "max_iter", "n_fit",
            "find_bg", "pos_bg", "device", "intensity", "xs_kind",
            "xs_col")])


# the C entries (cuda_lib.Entry): K1, K2, and K3's rungs of each, which
# take the rung and, for K1's, the group width after the struct
_K1_SHAPE = ("group", "threads", "registers", "local_bytes")
_K2_SHAPE = _K1_SHAPE + ("source", "smem_bytes", "ft_parts")
_K1 = cuda_lib.Entry("mc_chunk", _ChunkParams, _K1_SHAPE)
_K2 = cuda_lib.Entry("mc_prefetch", _PrefetchParams, _K2_SHAPE)
_K3 = cuda_lib.Entry("mc_probe", _ChunkParams, _K1_SHAPE, n_extra=2)
_K3_K2 = cuda_lib.Entry("mc_probe_prefetch", _PrefetchParams, _K2_SHAPE,
                        library="mc_probe", n_extra=1)


# ---------------------------------------------------------- the wrapper

def _check(state, consts: FitConstants, spec: ChunkSpec, proposals,
           what: str = "proposals"):
    dev = state.rset.device
    r, n, p = state.rset.shape
    nq = consts.n
    want = {"rset": (r, n, p), "ibank": (r, n, nq), "ft": (r, nq),
            "scale": (r,), "background": (r,), "conval": (r,),
            "n_iter": (r,), "n_moves": (r,)}
    for name, shape in want.items():
        dt = torch.int32 if name in ("n_iter", "n_moves") else torch.float32
        cuda_lib.require(f"state.{name}", getattr(state, name), dt, shape,
                         dev)
    for name, t in (("consts.y", consts.y), ("consts.u", consts.u),
                    ("spec.kern.grid", spec.kern.grid)):
        cuda_lib.require(name, t, torch.float32, (nq,), dev)
    if n != spec.n_contribs or p != len(spec.ranges):
        raise ValueError(f"state has N={n}, P={p}; spec wants "
                         f"N={spec.n_contribs}, P={len(spec.ranges)}")
    if proposals is not None:          # (S, R, K, P), any S
        cuda_lib.require(what, proposals, torch.float32,
                         (*proposals.shape[:1], r, spec.k_cand, p), dev)


def _shared_params(state, ri: int, consts: FitConstants, spec: ChunkSpec,
                   n_steps: int, sink, choice) -> dict:
    """The fields K1's and K2's parameter structs share: the fit's and
    the state's pointers, the solve's sums, the step's scalars and
    sizes."""
    r, n, p = state.rset.shape
    return dict(
        y=consts.y.data_ptr(), u=consts.u.data_ptr(),
        **{f: getattr(state, f).data_ptr() for f in _STATE_PTRS},
        sink=cuda_lib.ptr(sink), trace=cuda_lib.ptr(choice), s_u=consts.s_u,
        s_uy=consts.s_uy, crit=spec.crit, row_clamp=spec.kern.row_clamp,
        n_reps=r, n_contribs=n, nq=consts.n, n_params=p,
        k_cand=spec.k_cand, n_steps=n_steps, ri0=ri % n,
        max_iter=min(spec.max_iter, 2 ** 31 - 1), n_fit=consts.n,
        find_bg=int(spec.find_bg), pos_bg=int(spec.pos_bg),
        device=cuda_lib.device_index(state.rset.device))


def _chunk_params(state, ri: int, consts: FitConstants, spec: ChunkSpec,
                  proposals, seed, n_steps: int, sink=None,
                  choice=None, rep_base: int = 0) -> _ChunkParams:
    """The kernel's parameter struct for one chunk (K1 and K3)."""
    pfix, pcol, sw = spec.model_layout
    kern = spec.kern
    prm = _ChunkParams(
        **_shared_params(state, ri, consts, spec, n_steps, sink, choice),
        q=kern.grid.data_ptr(), proposals=cuda_lib.ptr(proposals),
        comp2=kern.comp2, local_scale=spec.local_scale,
        inv_v_ref=kern.inv_v_ref, inv_i_ref=kern.inv_i_ref,
        sw_fixed=sw or 0.0, n_model_params=len(pcol),
        k_global=spec.k_global, model_id=model_id(spec.model),
        vol_fixed=int(sw is not None), rep_base=rep_base,
        seed=(seed or 0) & 0xFFFFFFFF)
    for ip, ((lo, hi), g) in enumerate(zip(spec.ranges, spec.generators)):
        prm.lo[ip], prm.hi[ip], prm.gen[ip] = lo, hi, _GEN_CODES[g]
    for j, (v, c) in enumerate(zip(pfix, pcol)):
        prm.pfix[j], prm.pcol[j] = v, c
    return prm


def _chunk_steps(state, consts, spec, proposals, seed, n_steps):
    """Checks a K1/K3 call and returns its step count."""
    _check(state, consts, spec, proposals)
    if proposals is not None:
        if n_steps is not None and n_steps != proposals.shape[0]:
            raise ValueError("n_steps disagrees with proposals.shape[0]")
        n_steps = int(proposals.shape[0])
    if state.rset.device.type == "cuda":
        if proposals is None and (seed is None or n_steps is None):
            raise ValueError("the Philox mode needs seed and n_steps")
        if spec.k_cand < 1 or not 0 <= spec.k_local <= spec.k_cand:
            raise ValueError(f"invalid candidate split: K={spec.k_cand}, "
                             f"{spec.k_local} local")
    return n_steps


def run_chunk(state, ri: int, consts: FitConstants, spec: ChunkSpec,
              proposals: Optional[torch.Tensor] = None,
              seed: Optional[int] = None, n_steps: Optional[int] = None,
              trace: Optional[dict] = None, rep_base: int = 0):
    """Runs one chunk on the state's device, updating it in place;
    returns ``(state, cursor)``.

    CUDA tensors launch the kernel: with *proposals* (S, R, K, P) it uses
    them, otherwise it draws from its Philox stream keyed by *seed* for
    *n_steps* steps, repetition r of the state drawing the stream of
    repetition ``rep_base + r`` (a shard of an ensemble draws what the
    whole ensemble draws for it).  CPU tensors run
    :func:`chunk_reference`, which needs *proposals*.  With a *trace*
    dict the chosen candidate per step lands in ``trace["choice"]``
    (S, R) int32, -1 where nothing was accepted.
    """
    n_steps = _chunk_steps(state, consts, spec, proposals, seed, n_steps)
    dev = state.rset.device
    if dev.type == "cpu":
        if proposals is None:
            raise ValueError("the plain chunk on CPU tensors needs "
                             "injected proposals")
        return chunk_reference(state, ri, consts, spec, proposals, trace)
    if dev.type != "cuda":
        raise ValueError(f"no chunk implementation for device {dev}")
    r, n, _ = state.rset.shape
    choice = (torch.empty((n_steps, r), dtype=torch.int32, device=dev)
              if trace is not None else None)
    prm = _chunk_params(state, ri, consts, spec, proposals, seed, n_steps,
                        choice=choice, rep_base=rep_base)
    cuda_lib.launch(_K1, prm, dev)
    run_chunk.launches += 1
    name = spec.model.name
    run_chunk.model_launches[name] = run_chunk.model_launches.get(name,
                                                                  0) + 1
    if trace is not None:
        trace["choice"] = choice
    return state, (ri + n_steps) % n


run_chunk.launches = 0
run_chunk.model_launches = {}


def _check_probe(level: str, group: int):
    if level not in PROBE_LEVELS:
        raise ValueError(f"unknown probe level {level!r}; one of "
                         f"{PROBE_LEVELS}")
    if group and (group not in PROBE_GROUPS or level not in ("ff",
                                                             "solve")):
        raise ValueError(f"group width {group}: the ff and solve rungs "
                         f"run at {PROBE_GROUPS} lanes, every rung at 0 "
                         f"(K1's own)")


def launch_shape(state, consts: FitConstants, spec: ChunkSpec,
                 level: str = "full", group: int = 0) -> dict:
    """The launch shape of K1 (``level="full"``, ``group=0``) or of a K3
    rung for this chunk on the state's CUDA device: ``group`` (lanes per
    candidate), ``threads`` per block, ``registers`` and ``local_bytes``
    (local memory, spills included) per thread of the instantiation that
    runs."""
    _check_probe(level, group)
    prm = _chunk_params(state, 0, consts, spec, None, 0, 0)
    if level == "full" and not group:
        return cuda_lib.shape(_K1, prm)
    return cuda_lib.shape(_K3, prm, PROBE_LEVELS.index(level), group)


def run_probe(state, ri: int, consts: FitConstants, spec: ChunkSpec,
              level: str, proposals: Optional[torch.Tensor] = None,
              seed: Optional[int] = None, n_steps: Optional[int] = None,
              group: int = 0):
    """Runs one chunk of K1 cut at the rung *level* (:data:`PROBE_LEVELS`)
    on the state's device; returns ``(state, cursor, sink)``, *sink* the
    (R, threads) floats a rung below ``full`` leaves behind (None for
    ``full``).  Only ``full`` changes the state, as :func:`run_chunk`
    does.  *group*: lanes per candidate, 0 for K1's own, one of
    :data:`PROBE_GROUPS` for the ``ff`` and ``solve`` rungs.  Other
    arguments as for :func:`run_chunk`; CUDA tensors launch K3 (counted
    in ``run_probe.launches``).  On CPU tensors ``full`` runs
    :func:`chunk_reference`; a shorter rung has no plain version and
    raises."""
    _check_probe(level, group)
    n_steps = _chunk_steps(state, consts, spec, proposals, seed, n_steps)
    dev = state.rset.device
    if dev.type == "cpu":
        if level != "full" or proposals is None:
            raise ValueError(f"the probe's {level!r} rung measures the CUDA "
                             "kernel; only 'full' on injected proposals "
                             "has a plain version")
        return (*chunk_reference(state, ri, consts, spec, proposals), None)
    if dev.type != "cuda":
        raise ValueError(f"no probe implementation for device {dev}")
    r, n, _ = state.rset.shape
    sink = None
    if level != "full":
        threads = launch_shape(state, consts, spec, level, group)["threads"]
        sink = torch.empty((r, threads), dtype=torch.float32, device=dev)
    prm = _chunk_params(state, ri, consts, spec, proposals, seed, n_steps,
                        sink=sink)
    cuda_lib.launch(_K3, prm, dev, PROBE_LEVELS.index(level), group)
    run_probe.launches += 1
    return state, (ri + n_steps) % n, sink


run_probe.launches = 0


def _check_table(sw, cands, state, consts, spec):
    """Checks what K2's table entry takes besides the state and the
    candidates: the table, its axis layout and the factors, whose kind
    must be the one the table's rows need (a plain tensor counts as
    √w)."""
    dev = state.rset.device
    sw, kind = (sw if isinstance(sw, TableFactors)
                else TableFactors(sw, "sqrt_w"))
    if sw is None:
        raise ValueError("sw: K2's table entry needs its per-candidate "
                         "factors (table_factors)")
    want_kind = "w" if spec.kern.table_is_intensity else "sqrt_w"
    if kind != want_kind:
        raise ValueError(
            f"sw: the table's rows are "
            f"{'intensities' if want_kind == 'w' else 'amplitudes'} and "
            f"take the factor {want_kind!r}, got {kind!r} (table_factors "
            f"gives the right one)")
    table = spec.kern.table
    if table is None:
        raise ValueError("table: this engine has no parameter table")
    vals = table.values                # (rows, Nq)
    cuda_lib.require("table", vals, torch.float32,
                     (*vals.shape[:1], consts.n), dev)
    layout = spec.table_layout
    n_rows = int(np.prod([ax[4] for ax in layout], dtype=np.int64))
    if n_rows != vals.shape[0] or vals.numel() >= 2 ** 31:
        raise ValueError(f"table: its axes {[ax[4] for ax in layout]} give "
                         f"{n_rows} rows, the values have {vals.shape[0]} "
                         f"(at most 2^31 values in all)")
    cuda_lib.require("sw", sw, torch.float32, cands.shape[:-1], dev)


def _prefetch_params(state, ri: int, consts: FitConstants, spec: ChunkSpec,
                     cands, rows=None, sw=None, sink=None,
                     choice=None) -> _PrefetchParams:
    """The kernel's parameter struct for one segment (K2 and its K3
    rungs): rows in with *rows*, else table in with *sw* (a tensor, or
    :class:`TableFactors`) and the lookup's factor of each point
    (``spec.factor_layout``) on the fit grid."""
    if isinstance(sw, TableFactors):
        sw = sw.values
    prm = _PrefetchParams(
        **_shared_params(state, ri, consts, spec, int(cands.shape[0]), sink,
                         choice),
        rows=cuda_lib.ptr(rows), cands=cands.data_ptr(),
        sw=cuda_lib.ptr(sw))
    if rows is None:
        prm.table = spec.kern.table.values.data_ptr()
        prm.n_table_rows = spec.kern.table.values.shape[0]
        prm.intensity = int(spec.kern.table_is_intensity)
        prm.n_axes = len(spec.table_layout)
        prm.xs_kind, prm.xs_col, prm.xs_fixed = spec.factor_layout
        prm.q = spec.kern.grid.data_ptr()
        for a, (col, fixed, l0, dl, n_ax, hi) in enumerate(
                spec.table_layout):
            prm.ax_col[a], prm.ax_fixed[a] = col, fixed
            prm.ax_l0[a], prm.ax_dl[a] = l0, dl
            prm.ax_n[a], prm.ax_hi[a] = n_ax, hi
    return prm


def _check_prefetch(state, consts, spec, cands, rows, sw):
    """Checks a K2 call, rows in (*rows*) or table in (*sw*)."""
    _check(state, consts, spec, cands, "cands")
    if rows is not None:
        cuda_lib.require("rows", rows, torch.float32,
                         (*cands.shape[:-1], consts.n), state.rset.device)
    else:
        _check_table(sw, cands, state, consts, spec)
    dev = state.rset.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no prefetch chunk implementation for device "
                         f"{dev}")


def _run_prefetch(wrapper, state, ri, consts, spec, cands, rows, sw, trace):
    """Launches K2 on CUDA tensors that passed :func:`_check_prefetch`,
    counting in ``wrapper.launches``; returns ``(state, cursor)``."""
    dev = state.rset.device
    n_steps, r, n = int(cands.shape[0]), *state.rset.shape[:2]
    choice = (torch.empty((n_steps, r), dtype=torch.int32, device=dev)
              if trace is not None else None)
    cuda_lib.launch(_K2, _prefetch_params(state, ri, consts, spec, cands,
                                          rows, sw, choice=choice), dev)
    wrapper.launches += 1
    if trace is not None:
        trace["choice"] = choice
    return state, (ri + n_steps) % n


def run_prefetch_chunk(state, ri: int, consts: FitConstants,
                       spec: ChunkSpec, rows: torch.Tensor,
                       cands: torch.Tensor, trace: Optional[dict] = None):
    """Runs one prefetch segment on given rows (K2's rows-in entry) on the
    state's device, updating it in place; returns ``(state, cursor)``.

    *rows* (S, R, K, Nq) and *cands* (S, R, K, P) are one segment's
    candidate rows and candidates (:func:`segment_candidates`).  CUDA
    tensors launch K2 (counted in ``run_prefetch_chunk.launches``); CPU
    tensors run :func:`prefetch_reference`.  With a *trace* dict the
    chosen candidate per step lands in ``trace["choice"]`` (S, R) int32,
    -1 where nothing was accepted."""
    _check_prefetch(state, consts, spec, cands, rows, None)
    if state.rset.device.type == "cpu":
        return prefetch_reference(state, ri, consts, spec, rows, cands,
                                  trace)
    return _run_prefetch(run_prefetch_chunk, state, ri, consts, spec, cands,
                         rows, None, trace)


run_prefetch_chunk.launches = 0


def run_prefetch_table_chunk(state, ri: int, consts: FitConstants,
                             spec: ChunkSpec, cands: torch.Tensor, sw,
                             trace: Optional[dict] = None):
    """Runs one prefetch segment on the engine's parameter table (K2's
    table-in entry, the fit path) on the state's device, updating it in
    place; returns ``(state, cursor)``.

    *cands* (S, R, K, P) are the segment's candidates
    (:func:`segment_candidates`) and *sw* their factors
    (:func:`table_factors`; a plain (S, R, K) tensor is taken as √w,
    :func:`sqrt_weights`); the kernel blends each candidate's row from
    ``spec.kern.table`` by ``spec.table_layout``, as the lookup and
    ``IntensityKernel.row`` do, for an amplitude and for an intensity
    table.  CUDA tensors launch K2 (counted in
    ``run_prefetch_table_chunk.launches``); CPU tensors run
    :func:`prefetch_table_reference`.  *trace* as for
    :func:`run_prefetch_chunk`.  A segment with the lookup's row factor
    counts in ``ops.mc_kernel.cross_section``."""
    _check_prefetch(state, consts, spec, cands, None, sw)
    _count_row_factor(spec.kern)
    if state.rset.device.type == "cpu":
        return prefetch_table_reference(state, ri, consts, spec, cands,
                                        trace)
    return _run_prefetch(run_prefetch_table_chunk, state, ri, consts, spec,
                         cands, None, sw, trace)


run_prefetch_table_chunk.launches = 0


def _prefetch_level(level: str) -> int:
    if level not in PREFETCH_PROBE_LEVELS:
        raise ValueError(f"unknown K2 probe level {level!r}; one of "
                         f"{PREFETCH_PROBE_LEVELS}")
    return PREFETCH_PROBE_LEVELS.index(level)


def prefetch_launch_shape(state, consts: FitConstants, spec: ChunkSpec,
                          cands: torch.Tensor,
                          rows: Optional[torch.Tensor] = None,
                          level: str = "full") -> dict:
    """The launch shape of K2 (``level="full"``) or of one of its K3
    rungs for this segment on the state's CUDA device, rows in with
    *rows*, else table in: ``group`` (lanes per candidate), ``threads``
    per block, ``registers`` and ``local_bytes`` per thread, ``source``
    (where a candidate's row comes from, one of :data:`PREFETCH_SOURCES`:
    the kernel's shape rule), ``smem_bytes`` of dynamic shared memory and
    ``ft_parts``, the warps that share the segment-start sum of the
    bank."""
    prm = _prefetch_params(state, 0, consts, spec, cands, rows)
    if level == "full":
        shape = cuda_lib.shape(_K2, prm)
    else:
        shape = cuda_lib.shape(_K3_K2, prm, _prefetch_level(level))
    shape["source"] = PREFETCH_SOURCES[shape["source"]]
    return shape


def run_prefetch_probe(state, ri: int, consts: FitConstants,
                       spec: ChunkSpec, level: str, cands: torch.Tensor,
                       rows: Optional[torch.Tensor] = None, sw=None):
    """Runs one segment of K2 cut at the rung *level*
    (:data:`PREFETCH_PROBE_LEVELS`) on the state's CUDA device, rows in
    with *rows*, else table in with *sw*; returns ``(state, cursor,
    sink)``, *sink* the (R, threads) floats a rung below ``full`` leaves
    behind (None for ``full``).  Only ``full`` changes the state, as K2
    does.  Launches K3 (counted in ``run_probe.launches``); a cut step
    has no plain version, so CPU tensors raise."""
    lv = _prefetch_level(level)
    _check_prefetch(state, consts, spec, cands, rows, sw)
    dev = state.rset.device
    if dev.type != "cuda":
        raise ValueError("the probe's K2 rungs measure the CUDA kernel; on "
                         "CPU tensors use the plain versions")
    sink = None
    if level != "full":
        threads = prefetch_launch_shape(state, consts, spec, cands, rows,
                                        level)["threads"]
        sink = torch.empty((state.rset.shape[0], threads),
                           dtype=torch.float32, device=dev)
    cuda_lib.launch(_K3_K2, _prefetch_params(state, ri, consts, spec, cands,
                                             rows, sw, sink=sink), dev, lv)
    run_probe.launches += 1
    return state, (ri + int(cands.shape[0])) % state.rset.shape[1], sink
