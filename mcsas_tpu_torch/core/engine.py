# -*- coding: utf-8 -*-
"""The Monte-Carlo fitting engine: reference McSAS.mcFit/analyse rebuilt as
a chunked loop over a fixed-shape state of tensors on one device.

Reference control flow (src/mcsas/mcsas/mcsas.py:287-439): a Python while
loop mutating one contribution at a time, with a scipy LM fit of scale and
background per iteration.  The recast, shared with the JAX package
(mcsas_tpu/core/engine.py):

* Per repetition the state carries the full per-contribution intensity
  bank ``ibank`` (N × Nq, float32), so the incremental total update is
  ``ft − ibank[ri] + I(rt)``: one row evaluation per candidate.
* The scale/background fit is the closed-form solve of :mod:`fitcore`.
* The data-dependent ``while χ² > crit`` becomes a chunked loop: one chunk
  runs ``chunk_steps`` masked steps on the device (the fused CUDA kernel,
  or its plain PyTorch version), and convergence / retry / abort are
  decided on the host between chunks.
* ``candidates_per_step`` (K) proposals for the same slot are evaluated
  per step and the best improving one is accepted.
* On the parameter-table tier (quadrature models, float32) a chunk is one
  prefetch segment: its proposals are drawn up front, and the prefetch
  kernel K2 blends each candidate's row from the table and runs the steps
  (its plain version evaluates the rows with the table lookup first).
  An elementwise model without a device function of K1 (a user's
  plugin) runs prefetch segments too: its rows are evaluated by its own
  ``ff`` before K2's rows-in entry is launched.
* Rows are computed with the weight normalized by a host-side float64
  reference volume (w/w_ref), so float32 never touches the ~1e-32 SI
  magnitudes; the fitted scale absorbs the factor exactly.

The contribution cursor ``ri`` is deterministic and shared by every
repetition; it is carried across chunks and retries as a host integer.
``ft`` is refreshed from the bank at every chunk start, which bounds the
incremental float32 drift to one chunk.
"""
from __future__ import annotations

import inspect
import logging
import math
import time
from dataclasses import dataclass, fields
from typing import Callable, Optional

import numpy as np
import torch

from ..config import McSASConfig
from ..data import SASData
from ..models.base import BoundModel
from ..ops import bank_route, cuda_lib, mc_kernel
from ..ops.tables import ParamTable, grid_fingerprint
from ..utils import profiling
from .fitcore import FitConstants, make_constants, solve_scale_bg
from .rng import draw_params, local_candidates, whole_vectors

log = logging.getLogger(__name__)

__all__ = ["RepState", "EngineResult", "IntensityKernel", "McSASEngine",
           "chunk_vectors", "fresh_state", "local_candidates",
           "magnitude_probe", "make_intensity_kernels", "memo_probe",
           "resolve_device", "state_from_numpy", "state_to_numpy"]


@dataclass
class RepState:
    """MC state of the whole ensemble, batched with a leading rep axis.

    The chunk kernel and its plain version update these tensors in place.
    """
    rset: torch.Tensor       # (R, N, P) contribution parameters, SI
    ibank: torch.Tensor      # (R, N, Nq) per-contribution rows (normalized)
    ft: torch.Tensor         # (R, Nq) total intensity
    scale: torch.Tensor      # (R,) fitted A (normalized-intensity units)
    background: torch.Tensor  # (R,)
    conval: torch.Tensor     # (R,) current reduced χ²
    n_iter: torch.Tensor     # (R,) int32 proposals consumed this attempt
    n_moves: torch.Tensor    # (R,) int32 accepted moves

    def clone(self) -> "RepState":
        return RepState(**{f.name: getattr(self, f.name).clone()
                           for f in fields(self)})

    def copy_(self, src: "RepState") -> "RepState":
        """Copies *src* into this state's tensors in place, allocating
        nothing (a timing loop restores its start state this way)."""
        for f in fields(self):
            getattr(self, f.name).copy_(getattr(src, f.name))
        return self

    def merge(self, fresh: "RepState", mask: torch.Tensor) -> "RepState":
        """Rows of *fresh* where *mask* (R,) is True, else this state's
        (retry semantics: reference mcsas.py:217-246 re-runs mcFit)."""
        def pick(new, old):
            m = mask.reshape((-1,) + (1,) * (old.dim() - 1))
            return torch.where(m, new, old)
        return RepState(**{f.name: pick(getattr(fresh, f.name),
                                        getattr(self, f.name))
                           for f in fields(self)})


_INT_FIELDS = ("n_iter", "n_moves")


def state_from_numpy(arrays: dict, device="cpu",
                     dtype=torch.float32) -> RepState:
    """Builds a state from numpy arrays keyed by the field names of
    :class:`RepState` — e.g. the fields of a JAX ``RepState`` fetched to
    the host (its per-rep ``key`` is ignored: this package keeps its
    random stream in a ``torch.Generator``)."""
    out = {}
    for f in fields(RepState):
        dt = torch.int32 if f.name in _INT_FIELDS else dtype
        # a copy: the chunk updates the state in place
        out[f.name] = torch.tensor(np.asarray(arrays[f.name]), dtype=dt,
                                   device=device)
    return RepState(**out)


def state_to_numpy(state: RepState) -> dict:
    """The state's fields as host numpy arrays (dtype kept)."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in fields(state)}


# the quantities debug_guards checks once a chunk, by bit of the flag
_GUARDED = ("chi2", "ft", "scale", "background")


def chunk_vectors(state: RepState, guard=None) -> torch.Tensor:
    """What the host reads of a state once a chunk, as one float64 (k, R)
    tensor on the state's device: χ², the proposals consumed and, with
    *guard* (the ``(nans, infs)`` of ``utils.profiling.debug_guards``), a
    flag per repetition whose bit i is set where ``_GUARDED[i]`` holds a
    value the guard forbids."""
    rows = [state.conval.double(), state.n_iter.double()]
    if guard:
        nans, infs = guard
        flag = torch.zeros_like(rows[0])
        for bit, t in enumerate((state.conval, state.ft, state.scale,
                                 state.background)):
            v = t.reshape(t.shape[0], -1)
            bad = torch.zeros_like(flag, dtype=torch.bool)
            if nans:
                bad |= torch.isnan(v).any(dim=1)
            if infs:
                bad |= torch.isinf(v).any(dim=1)
            flag += bad.double() * float(2 ** bit)
        rows.append(flag)
    return torch.stack(rows)


def _raise_guarded(flags: np.ndarray, chunk: int, guard) -> None:
    """Raises FloatingPointError for the first repetition *flags* (R,)
    marks (:func:`chunk_vectors`)."""
    bad = np.flatnonzero(flags)
    if not bad.size:
        return
    rep = int(bad[0])
    what = [name for bit, name in enumerate(_GUARDED)
            if int(flags[rep]) >> bit & 1]
    kinds = " or ".join(k for k, on in zip(("NaN", "inf"), guard) if on)
    raise FloatingPointError(
        f"debug_guards: after chunk {chunk}, repetition {rep} holds a "
        f"{kinds} in {', '.join(what)} ({bad.size} repetition(s) in all)")


def fresh_state(rset: torch.Tensor, kern, consts, cfg: McSASConfig):
    """A fresh state of the repetitions in *rset* (R, N, P): their rows,
    ft (a float64 sum) and the solve.  With lists of q-shard kernels and
    constants (``parallel.spmd``) it returns one RepState per shard, on
    the shard kernel's device: each holds its columns of the bank and of
    ft and a copy of the rest, the solve joined across the shards."""
    shards = isinstance(kern, (list, tuple))
    kerns, cs = (kern, consts) if shards else ([kern], [consts])
    banks = [k.row(rset.to(k.grid.device)).contiguous() for k in kerns]
    fts = [b.double().sum(dim=1).to(rset.dtype) for b in banks]
    sol = solve_scale_bg(fts, cs, cfg.find_background,
                         cfg.positive_background)
    cells = []
    for k, bank, ft in zip(kerns, banks, fts):
        dev, copy = k.grid.device, len(kerns) > 1
        zero = torch.zeros(rset.shape[0], dtype=torch.int32, device=dev)
        cells.append(RepState(
            rset=rset.to(dev, copy=copy), ibank=bank, ft=ft,
            scale=sol.scale.to(dev, copy=copy).contiguous(),
            background=sol.background.to(dev, copy=copy).contiguous(),
            conval=sol.chisqr.to(dev, copy=copy).contiguous(),
            n_iter=zero, n_moves=zero.clone()))
    return cells if shards else cells[0]


@dataclass
class EngineResult:
    """Raw engine output for one ensemble run (numpy, host)."""
    contribs: np.ndarray      # (R, N, P) SI
    conval: np.ndarray        # (R,)
    n_iter: np.ndarray        # (R,)
    n_moves: np.ndarray       # (R,)
    attempts: np.ndarray      # (R,) mcFit attempts used
    converged: np.ndarray     # (R,) bool
    scaling: np.ndarray       # (R,) scale in SI intensity units
    background: np.ndarray    # (R,)
    measval: np.ndarray       # (R, Nq) fitted model curve A·I+b (data units)
    w_ref: float              # weight normalization used on device
    elapsed: float            # seconds
    iters_per_sec: float
    moves_per_sec: float
    # True only when a CUDA chunk kernel (K1 or K2) ran
    used_pallas: bool = False
    # the form factor came from a parameter table
    used_table: bool = False
    # True only when the prefetch kernel K2 ran
    used_prefetch: bool = False
    # accumulated over ALL attempts (retried repetitions included) — the
    # per-rep n_iter above resets on retry
    total_iters: int = 0
    reps_trimmed: bool = False
    # chunks (prefetch segments) launched
    n_chunks: int = 0
    # summed over chunks: the repetitions still running when it launched
    rep_chunks: int = 0
    # the proposals of attempts that were later retried (in total_iters)
    retried_iters: int = 0

    @property
    def num_reps(self) -> int:
        return self.contribs.shape[0]


def resolve_device(device) -> torch.device:
    """The explicit compute device; asking for CUDA without a card raises
    instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


def magnitude_probe(bound: BoundModel, probe_grid, two_d_psi=None) -> float:
    """Float64 form-factor-magnitude normalization probe at the geometric
    midpoint of the active ranges: i_ref = max |ff²| on the given grid
    (with *two_d_psi*, of ``ff2d`` on the (q, ψ) pairs of a 2D grid).

    The form factor can carry huge constant factors which overflow float32
    just as SI volume weights underflow it; scaling device rows by 1/i_ref
    keeps them O(1), and the fitted scale absorbs the factor exactly.
    Evaluated in float64 on the CPU."""
    mids = np.asarray([np.sqrt(max(lo, 1e-300) * hi) if hi > 0 else lo
                       for lo, hi in bound.ranges], np.float64)
    grid = torch.as_tensor(np.asarray(probe_grid, np.float64))
    if two_d_psi is not None:
        ffp = bound.model.ff2d(
            grid, torch.as_tensor(np.asarray(two_d_psi, np.float64)),
            bound.pdict(torch.as_tensor(mids)))
    else:
        ffp = bound.ff(grid, torch.as_tensor(mids))
    probe = np.abs(np.asarray(ffp * ffp, np.float64))
    i_ref = float(np.nanmax(probe))
    if not np.isfinite(i_ref) or i_ref <= 0.0:
        i_ref = 1.0
    return i_ref


# i_ref of the last few (model, probe grid, ψ) keys: a series of frames on
# one grid builds an engine a frame, and the probe reads nothing of a
# frame's intensities.  Oldest entry out first.
_PROBE_MEMO: dict = {}
_PROBE_MEMO_CAP = 8


def _grid_key(grid):
    return grid_fingerprint(grid), np.shape(grid)


def memo_probe(bound: BoundModel, probe_grid, two_d_psi=None) -> float:
    """:func:`magnitude_probe` through a per-process memo keyed by all it
    reads: the bound model, the probe grid's bytes and shape and, on 2D
    data, ψ's.  The probe is a pure float64 function of that key, so a hit
    returns its value bit for bit.  A model piece that cannot be hashed is
    probed every time.  Counters ``core.engine.probe_memo.hit`` and
    ``.miss``."""
    key = (bound, _grid_key(probe_grid),
           None if two_d_psi is None else _grid_key(two_d_psi))
    try:
        i_ref = _PROBE_MEMO.get(key)
    except TypeError:       # a model piece that cannot be hashed
        key = i_ref = None
    if i_ref is not None:
        profiling.count("core.engine.probe_memo.hit")
        return i_ref
    profiling.count("core.engine.probe_memo.miss")
    i_ref = magnitude_probe(bound, probe_grid, two_d_psi=two_d_psi)
    if key is not None:
        if len(_PROBE_MEMO) >= _PROBE_MEMO_CAP:
            _PROBE_MEMO.pop(next(iter(_PROBE_MEMO)))
        _PROBE_MEMO[key] = i_ref
    return i_ref


@dataclass(frozen=True)
class IntensityKernel:
    """The normalized intensity row of one (data, model, config) triple.

    ``row(pvec)`` maps parameter vectors (..., P) to rows (..., Nq):
    (ffv·√w)² with w = (v·inv_v_ref)^comp2 / i_ref, clamped at
    ``row_clamp``.  ffv is the model's form factor on the fit grid or,
    on the parameter-table tier, ``table_fn(table, pdict)``: the
    multilinear blend of the baked rows (ops/tables.py), which plays the
    part of the model's weights.  For smeared data (``locs`` set) the
    form factor is evaluated on the (Nq, n_off) grid of smearing offsets
    and the row is ((ffv·√w)²) @ smear_w; a smeared table
    (``table_is_intensity``) holds ff²(locs) @ smear_w already, and its
    row is blend·w (reference smearing path:
    src/mcsas/bases/model/sasmodel.py:56-73).  For 2D (q, ψ) data
    (``psi`` set) ffv is the model's anisotropic ``ff2d`` on the (q, ψ)
    pairs of the fit grid.  The scalars are what the
    CUDA kernels need to compute or consume the same rows.  The volume is
    scaled by a multiplication with the host reciprocal of v_ref, which
    eager PyTorch performs identically on the CPU and on CUDA (PyTorch
    turns a CUDA division by a host scalar into that multiplication), so
    the kernel can match it bitwise.
    """
    bound: BoundModel
    model_ff: Callable        # ff(grid, pdict), when there is no table
    grid: torch.Tensor        # (Nq,) fit grid, engine dtype and device
    w_ref: float              # v_ref^comp2 · i_ref: back to SI scale
    inv_v_ref: float
    comp2: float
    inv_i_ref: float
    row_clamp: float
    table: Optional[ParamTable] = None
    table_fn: Optional[Callable] = None   # (table, pdict) -> (..., Nq)
    # smeared data: the (Nq, n_off) evaluation grid and the contraction
    # vector (n_off,), engine dtype and device
    locs: Optional[torch.Tensor] = None
    smear_w: Optional[torch.Tensor] = None
    # the table's rows are smeared intensities, not amplitudes
    table_is_intensity: bool = False
    # 2D (q, ψ) data: the ψ of each fit-grid point, engine dtype and device
    psi: Optional[torch.Tensor] = None
    # the model's table factory was asked and made no table (the ψ-grid
    # cylinders' interpolation probe declined this binding)
    table_declined: bool = False

    def weight(self, pd: dict):
        """w = (v·inv_v_ref)^comp2 / i_ref of a parameter dict: a tensor,
        or a Python float (float64) when the volume depends on no active
        parameter."""
        return ((self.bound.model.volume(pd) * self.inv_v_ref) ** self.comp2
                * self.inv_i_ref)

    def row_weight(self, pvec: torch.Tensor) -> torch.Tensor:
        """w of parameter vectors (..., P) in the engine dtype: shape
        (..., 1), or 0-dim when the volume depends on no active
        parameter; one batch of whole CPU vectors, as :meth:`row`."""
        return whole_vectors(self._row_weight, pvec)

    def _row_weight(self, pvec: torch.Tensor) -> torch.Tensor:
        w = self.weight(self.bound.pdict(pvec[..., None, :]))
        if isinstance(w, torch.Tensor):
            return torch.as_tensor(w, dtype=self.grid.dtype,
                                   device=self.grid.device)
        # a volume of no active parameter: filled on the device, with the
        # rounding of a copy from the host but without its wait
        return torch.full((), w, dtype=self.grid.dtype,
                          device=self.grid.device)

    def sqrt_weight(self, pvec: torch.Tensor) -> torch.Tensor:
        """√w of parameter vectors (..., P), shaped as
        :meth:`row_weight`."""
        return torch.sqrt(self.row_weight(pvec))

    def row(self, pvec: torch.Tensor) -> torch.Tensor:
        """The rows (..., Nq) of parameter vectors (..., P), evaluated as
        one batch of whole CPU vectors (``rng.whole_vectors``): a row
        does not depend on the batch it is evaluated in."""
        return whole_vectors(self._row, pvec)

    def _row(self, pvec: torch.Tensor) -> torch.Tensor:
        if self.table_is_intensity:
            row = (self.table_fn(self.table, self.bound.pdict(pvec))
                   * self.row_weight(pvec))
            return torch.clamp_max(row, self.row_clamp)
        # normalize at AMPLITUDE level, (ffv·√w)² rather than ffv²·w: raw
        # |ff|² alone can underflow float32 (and 1/i_ref alone overflow
        # it), while the amplitude-scaled product is O(1) by construction
        s = self.sqrt_weight(pvec)
        if self.table is not None:
            ffv = self.table_fn(self.table, self.bound.pdict(pvec))
        elif self.psi is not None:
            ffv = self.bound.model.ff2d(self.grid, self.psi,
                                        self.bound.pdict(pvec[..., None, :]))
        elif self.locs is not None:
            # two grid axes (Nq, n_off) behind the parameter batch
            ffv = self.model_ff(self.locs,
                                self.bound.pdict(pvec[..., None, None, :]))
            fs = ffv * (s[..., None] if s.dim() else s)
            return torch.clamp_max((fs * fs) @ self.smear_w, self.row_clamp)
        else:
            ffv = self.model_ff(self.grid,
                                self.bound.pdict(pvec[..., None, :]))
        fs = ffv * s
        return torch.clamp_max(fs * fs, self.row_clamp)


def _takes_smear(factory) -> bool:
    """True when a table factory declares the ``smear`` keyword."""
    try:
        return "smear" in inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return False


def make_intensity_kernels(bound: BoundModel, data: SASData,
                           cfg: McSASConfig, dtype=torch.float32,
                           device="cpu", table_grid_width_only=False
                           ) -> IntensityKernel:
    """Builds the intensity row for the fit grid: of 1D data, smeared
    (``data.locs`` and ``data.smear_w``) or not, or of 2D (q, ψ) data
    (``data.psi``) with the model's ``ff2d``, where smearing is ignored
    and no table is made (the JAX package's 2D branch,
    mcsas_tpu/core/engine.py:183-205,315-318).

    A float32 engine of a model with a table factory reads its form
    factor from a parameter table baked on *device* when
    ``cfg.table_ff_enabled()``; for smeared data the table holds the
    smeared intensity, baked against the dataset's own contraction, and
    only a factory that declares the ``smear`` keyword is asked for one
    (the JAX package's table branch, mcsas_tpu/core/engine.py:236-279).

    *table_grid_width_only* takes only a table whose rows lie on the fit
    grid, one value column per q point: the layout a q shard can slice by
    columns.  A table on another inner grid (the smeared worm's rows on
    the flattened ``locs``, contracted inside its lookup) is then left
    out, and the rows come from the model's own rule, as the JAX package
    decides (mcsas_tpu/core/engine.py:171-180,266)."""
    two_d = data.psi is not None and bound.model.ff2d is not None
    if two_d and data.uses_smearing and bound.model.can_smear:
        log.warning("2D (q, psi) fitting ignores the smearing config: "
                    "the anisotropic kernel has no smeared variant")
    smearing = data.uses_smearing and bound.model.can_smear and not two_d
    comp2 = 2.0 * cfg.compensation_exponent
    v_ref = bound.reference_volume()
    grid = torch.as_tensor(np.asarray(data.q, np.float64)).to(
        device=device, dtype=dtype)
    locs = smear_w = None
    if smearing:
        locs = torch.as_tensor(np.asarray(data.locs, np.float64)).to(
            device=device, dtype=dtype)
        smear_w = torch.as_tensor(np.asarray(data.smear_w, np.float64)).to(
            device=device, dtype=dtype)
    psi = None
    if two_d:
        psi = torch.as_tensor(np.asarray(data.psi, np.float64)).to(
            device=device, dtype=dtype)
    with profiling.span("core.engine.probe"):
        i_ref = memo_probe(bound, data.locs if smearing else data.q,
                           two_d_psi=data.psi if two_d else None)
    model_ff = bound.model.ff
    if dtype == torch.float32 and bound.model.ff_fast is not None:
        model_ff = bound.model.ff_fast
    table = table_fn = None
    table_is_intensity = table_declined = False
    factory = bound.model.ff_table_factory
    if smearing and factory is not None and not _takes_smear(factory):
        factory = None      # a factory that predates smeared tables
    if (dtype == torch.float32 and factory is not None and not two_d
            and cfg.table_ff_enabled()):
        kw = {}
        if smearing:
            kw["smear"] = (np.asarray(data.locs, np.float64),
                           np.asarray(data.smear_w, np.float64))
        with profiling.span("ops.tables.lookup"):
            made = factory(bound, np.asarray(data.q, np.float64), dtype,
                           torch.device(device), **kw)
        if made is not None and not (
                table_grid_width_only
                and made[1].values.shape[1] != grid.shape[0]):
            table_fn, table = made[:2]
            table_is_intensity = len(made) == 3 and made[2] == "intensity"
        table_declined = made is None

    # float32 overflow guard: candidate rows at extreme range corners can
    # reach (v/v_ref)^(2c)·(ff/ff_ref)² ≈ 1e20, and the solve's Σu·x²
    # then overflows float32.  Such candidates are unfittable anyway, so
    # clamping the row magnitude changes no accept decision.  The budget
    # is divided by num_contribs: ft sums N rows, so even with EVERY
    # contribution parked at the clamp Σu·ft² stays below the float32
    # overflow threshold.
    sigma = np.asarray(data.fu, np.float64).copy()
    sigma[sigma == 0.0] = 1.0
    u_max = float(np.max(1.0 / sigma ** 2))
    n_grid = float(np.asarray(data.q).shape[0])
    row_clamp = math.sqrt(3e37 / (max(u_max, 1e-300) * n_grid)) \
        / max(float(cfg.num_contribs), 1.0)
    row_clamp = max(row_clamp, 1e3)   # stay far above the working range

    return IntensityKernel(bound=bound, model_ff=model_ff, grid=grid,
                           w_ref=v_ref ** comp2 * i_ref,
                           inv_v_ref=1.0 / v_ref, comp2=comp2,
                           inv_i_ref=1.0 / i_ref, row_clamp=row_clamp,
                           table=table, table_fn=table_fn, locs=locs,
                           smear_w=smear_w,
                           table_is_intensity=table_is_intensity, psi=psi,
                           table_declined=table_declined)


class _HostReads:
    """Where the host reads a chunk's χ² and counters.  On the card: a
    copy, in stream order right behind the chunk, into a pinned host
    buffer, and an event that marks it done, so that the host can wait
    for chunk n's read while chunk n+1 is queued behind it.  Two buffers
    in turn, so that read n+1's copy never lands in the buffer of a read
    the host has not taken.  Elsewhere the read is the vector itself."""

    def __init__(self):
        self._slots = []
        self._turn = 0

    def post(self, vec: torch.Tensor):
        """Enqueues the copy of *vec* to the host; returns what
        :meth:`take` waits for."""
        if vec.device.type != "cuda":
            return vec, None
        if not self._slots:         # a run reads one shape throughout
            self._slots = [(torch.empty(vec.shape, dtype=vec.dtype,
                                        pin_memory=True), torch.cuda.Event())
                           for _ in range(2)]
        buf, done = self._slots[self._turn]
        self._turn ^= 1
        buf.copy_(vec, non_blocking=True)
        done.record(torch.cuda.current_stream(vec.device))
        return buf, done

    @staticmethod
    def take(posted) -> np.ndarray:
        """Waits for a posted read; returns it as an array of its own."""
        vec, done = posted
        if done is None:
            return vec.cpu().numpy()
        done.synchronize()
        return vec.numpy().copy()


class McSASEngine:
    """MC fitter for one (data, model, config) triple on one device.

    Reusable across runs: a run restarts the engine's generator from
    ``cfg.seed``, so two runs of one engine give the same result.
    """
    # a q-sharded engine takes only tables that lie on the fit grid
    _table_grid_width_only = False

    def __init__(self, data: SASData, bound: BoundModel, cfg: McSASConfig,
                 device="cuda"):
        if data.count < 1:
            raise ValueError("no data points on the fit grid")
        for name, (lo, hi) in zip(bound.active, bound.ranges):
            if not (np.isfinite(lo) and np.isfinite(hi)):
                raise ValueError(
                    f"active range of {name!r} is not finite ({lo}, {hi}); "
                    "set active_ranges when binding the model (fit() "
                    "defaults unbounded ranges to the data size estimate)")
        if cfg.use_pallas not in ("auto", "on", "off"):
            raise ValueError("use_pallas must be 'auto', 'on' or 'off'")
        with profiling.span("core.engine.construct"):
            self.data = data
            self.bound = bound
            self.cfg = cfg
            self.device = resolve_device(device)
            self.dtype = getattr(torch, cfg.dtype)
            self.n_contribs = cfg.num_contribs
            with profiling.span("core.engine.constants"):
                self.consts: FitConstants = make_constants(
                    data.f, data.fu, self.dtype, self.device)
            self.kern = make_intensity_kernels(
                bound, data, cfg, self.dtype, self.device,
                table_grid_width_only=self._table_grid_width_only)
            self.grid = self.kern.grid
            self.w_ref = self.kern.w_ref
            self.uses_table = self.kern.table is not None
            self.spec = mc_kernel.ChunkSpec(
                model=bound.model, kern=self.kern,
                n_contribs=cfg.num_contribs, k_cand=cfg.candidates_per_step,
                k_local=self._k_local(), local_scale=float(cfg.local_scale),
                crit=float(cfg.convergence_criterion),
                max_iter=int(cfg.max_iterations),
                find_bg=bool(cfg.find_background),
                pos_bg=bool(cfg.positive_background),
                ranges=tuple(bound.ranges), generators=tuple(bound.generators))
            # which entry of K2 a segment launches: 'table' where the kernel
            # can blend this table itself, 'rows' where the rows are staged
            # first (the table's eager lookup, or an elementwise plugin's
            # ff); None without K2
            self.prefetch_entry = mc_kernel.prefetch_entry(self)
            # the engine's chunks are prefetch segments (K2 or its plain
            # version): always on the table tier; for an elementwise plugin
            # unless use_pallas='off' or the engine takes no kernel (a q
            # axis), which run the plain chunk, as the JAX package runs its
            # scan there.  Any other engine runs K1 chunks or their plain
            # version
            self.runs_prefetch = self.uses_table or (
                self.prefetch_entry is not None and cfg.use_pallas != "off"
                and self._kernel_eligible())
            self.seg_steps = (mc_kernel.prefetch_seg_steps(self)
                              if self.runs_prefetch else None)
            self.runs_cuda_kernel = self._kernel_route()
            self.gen = torch.Generator(device=self.device)

    def _kernel_route(self) -> bool:
        """True when chunks launch a CUDA kernel: K1 where it can run the
        config, else K2 where it can.  On the card only an explicit
        ``use_pallas='off'`` picks the plain version; a config neither
        kernel can run raises there, as it does anywhere under 'on'."""
        mode = self.cfg.use_pallas
        if mode == "off":
            return False
        on_card = self.device.type == "cuda"
        if not self._kernel_eligible() and (mode == "on" or on_card):
            raise ValueError(
                f"use_pallas={mode!r} on {self.device.type} but this "
                "model/config is not eligible for a chunk kernel (K1: "
                "Sphere, LMADenseSphere, GaussianChain or "
                "SphericalCoreShell, unsmeared, float32; K2: the "
                "parameter-table tier, float32, smeared tables included, "
                "and through its rows-in entry any other model that "
                "declares elementwise_q, 1D, unsmeared, float32); "
                f"{self._no_kernel_reason()}; pass use_pallas='off' for "
                "the plain PyTorch chunk")
        return on_card

    def _kernel_eligible(self) -> bool:
        """True when K1 or an entry of K2 (``prefetch_entry``) can run
        this configuration."""
        return (self.prefetch_entry is not None
                or mc_kernel.supports(self))

    def _no_kernel_reason(self) -> str:
        """Why neither chunk kernel runs this configuration, for the
        error of :meth:`_kernel_route`."""
        kern, name = self.kern, self.bound.model.name
        if kern.psi is not None:
            return ("this is a 2D (q, psi) fit: its rows come from the "
                    f"anisotropic ff2d of {name}, which no kernel "
                    "evaluates, and 2D takes no table")
        if self.dtype != torch.float32:
            return f"the config asks for {self.cfg.dtype}"
        if kern.locs is not None and not self.uses_table:
            return (f"this fit is smeared and {name} has no parameter "
                    "table, so no kernel runs its rows")
        if kern.table_declined:
            return (f"the interpolation probe declined {name}'s parameter "
                    "table for this binding (its rows oscillate along the "
                    "parameter axes faster than the table's nodes can "
                    "follow), and the model has no device function")
        if self.uses_table or self.bound.model.elementwise_q:
            return (f"K1 and K2 take 1 to {mc_kernel.MAX_P} active "
                    "parameters")
        return (f"{name} has no device function, is not elementwise in q "
                "(elementwise_q, which K2's rows-in entry takes) and, in "
                "this config, has no parameter table")

    def _k_local(self) -> int:
        """Number of candidates per step drawn as local moves."""
        return int(round(self.cfg.candidates_per_step
                         * self.cfg.local_moves))

    # ------------------------------------------------------------- build
    def _init_rset(self) -> torch.Tensor:
        """The parameters (R, N, P) of a fresh state, drawn from the
        generator."""
        cfg, bound = self.cfg, self.bound
        r, n, p = cfg.num_reps, self.n_contribs, bound.n_active
        if cfg.start_from_minimum:
            # deprecated reference option: start all contributions at half
            # the minimum of the active range (mcsas.py:310-315)
            mins = []
            for (lo, hi) in bound.ranges:
                if lo == 0.0:
                    lo = float(np.pi / self.data.q_limit[1])
                mins.append(0.5 * lo)
            rset = torch.tensor(mins, dtype=self.dtype,
                                device=self.device).expand(r, n, p)
            rset = rset.contiguous()
        else:
            rset = draw_params(
                self.gen, bound, count=r * n, dtype=self.dtype,
                vectors=self.spec.bounds(self.dtype, self.device)
            ).reshape(r, n, p)
        return rset

    def _init_batch(self) -> RepState:
        """Fresh state for every repetition, drawn from the generator."""
        return fresh_state(self._init_rset(), self.kern, self.consts,
                           self.cfg)

    def _draw_chunk_proposals(self, n_steps=None) -> torch.Tensor:
        """All proposals of one chunk in one draw: (S, R, K, P).  The last
        k_local candidate columns hold unit uniforms (turned into local
        moves against the slot's current value by the chunk)."""
        cfg = self.cfg
        s = cfg.chunk_steps if n_steps is None else n_steps
        r, p = cfg.num_reps, self.bound.n_active
        k_local = self._k_local()
        k_global = cfg.candidates_per_step - k_local
        parts = []
        if k_global:
            parts.append(draw_params(
                self.gen, self.bound, count=s * r * k_global,
                dtype=self.dtype,
                vectors=self.spec.bounds(self.dtype, self.device)
            ).reshape(s, r, k_global, p))
        if k_local:
            parts.append(torch.rand((s, r, k_local, p), generator=self.gen,
                                    dtype=self.dtype, device=self.device))
        return torch.cat(parts, dim=2).contiguous()

    def _chunk(self, state: RepState, ri: int):
        """One chunk of cfg.chunk_steps steps (an engine of prefetch
        segments: one segment of seg_steps steps); returns (state,
        cursor)."""
        if self.runs_prefetch:
            return self._segment(state, ri)
        if self.runs_cuda_kernel:
            # in-kernel Philox stream, keyed by a fresh per-chunk seed (its
            # int() waits on the card)
            with profiling.span("core.engine.draw"):
                seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                         generator=self.gen,
                                         device=self.device))
            with profiling.span("ops.mc_kernel.launch"):
                return mc_kernel.run_chunk(state, ri, self.consts,
                                           self.spec, seed=seed,
                                           n_steps=self.cfg.chunk_steps)
        # the CPU, or an explicit use_pallas='off': the plain chunk
        with profiling.span("core.engine.draw"):
            props = self._draw_chunk_proposals()
        with profiling.span("ops.mc_kernel.launch"):
            return mc_kernel.chunk_reference(state, ri, self.consts,
                                             self.spec, props)

    def _segment(self, state: RepState, ri: int):
        """One prefetch segment (mcsas_tpu/core/engine.py:404-417 and
        mc_kernel.py:771-818): the whole segment's proposals are drawn,
        the local ones moved around the segment-start slot values; then
        one launch of K2 runs the solve/accept sequence: its table entry
        blends every candidate's row from the table itself; for a table
        it cannot blend and for an elementwise plugin (``prefetch_entry
        == 'rows'``) the (S, R, K, Nq) rows are evaluated first, with the
        table lookup in blocks of steps or with the plugin's ``ff`` on
        the whole segment (``mc_kernel.segment_rows``), and go to its rows
        entry, as the plain version does everywhere."""
        with profiling.span("core.engine.draw"):
            props = self._draw_chunk_proposals(self.seg_steps)
        table = self.runs_cuda_kernel and self.prefetch_entry == "table"
        with profiling.span("ops.mc_kernel.factors"):
            cands = mc_kernel.segment_candidates(state, ri, self.spec, props)
            if table:
                made = mc_kernel.table_factors(self.spec, cands)
            else:
                made = mc_kernel.segment_rows(self.spec, cands)
        with profiling.span("ops.mc_kernel.launch"):
            if not self.runs_cuda_kernel:
                return mc_kernel.prefetch_reference(
                    state, ri, self.consts, self.spec, made, cands)
            if table:
                return mc_kernel.run_prefetch_table_chunk(
                    state, ri, self.consts, self.spec, cands, made)
            return mc_kernel.run_prefetch_chunk(
                state, ri, self.consts, self.spec, made, cands)

    # ----------------------------------------------------------- prewarm
    def prewarm(self) -> dict:
        """Pays the card's first-use costs of this engine's fits ahead of
        them, without running the MC: builds (nvcc, where build/kernels/
        lacks it) and loads the library of the kernel its chunks launch
        (``mc_chunk``, K1, or for prefetch segments ``mc_prefetch``, K2)
        and, where this fit's post pass launches a bank kernel (the route
        :func:`ops.bank_route.kernel_for`), that kernel's library in the
        same nvcc round; runs the batched init and the eager work
        before a first launch on a generator of its own, and asks CUDA for
        the attributes of the kernel instantiation that will run (which
        loads it).  The parameter table was baked in ``__init__`` (and
        persists through MCSAS_TPU_TABLE_CACHE_DIR).  The engine's
        generator and state are left as they were, so a fit after a
        prewarm is the fit without one, bit for bit.  Entry points:
        ``fit(..., prewarm=True)`` and the CLI's ``--prewarm``.

        Returns {label: seconds}; where no kernel runs this engine (the
        CPU, ``use_pallas='off'``) each label maps to a string saying why
        it was skipped.  A failed build, load or attribute query
        raises."""
        with profiling.span("core.engine.prewarm"):
            lib = "mc_prefetch" if self.runs_prefetch else "mc_chunk"
            labels = (f"nvcc {lib}", f"load {lib}", "init",
                      f"attributes {lib}")
            if not self.runs_cuda_kernel:
                why = (f"skipped: the plain chunk runs this engine on "
                       f"{self.device} "
                       f"(use_pallas={self.cfg.use_pallas!r})")
                return dict.fromkeys(labels, why)
            # the post pass's bank kernel, where this fit's post pass
            # launches one: built beside the chunk kernel's library
            bank = bank_route.kernel_for(self.bound, self.data, self.device)
            libs = (lib,) if bank is None else (lib, bank.ENTRY.library)
            builds = cuda_lib.build_libraries(libs)
            timings = {f"nvcc {name}": builds[name].seconds
                       for name in libs}
            for name in libs:
                t0 = time.perf_counter()
                cuda_lib.load(name)
                timings[f"load {name}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            own, self.gen = self.gen, torch.Generator(device=self.device)
            try:
                self.gen.manual_seed(self.cfg.seed)
                states = self._init_batch()
                props = (self._draw_chunk_proposals(self.seg_steps)
                         if self.runs_prefetch else None)
            finally:
                self.gen = own
            torch.cuda.synchronize(self.device)
            timings[labels[2]] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for state, consts, spec, mine in self._kernel_work(states,
                                                               props):
                shape = self._launch_shape(state, consts, spec, mine)
                torch.cuda.synchronize(state.rset.device)
                log.info("prewarm: %s on %s, launch shape %s", lib,
                         state.rset.device, shape)
            timings[labels[3]] = time.perf_counter() - t0
            log.info("prewarm: %s", timings)
            return timings

    def _kernel_work(self, state, props):
        """(state, constants, spec, proposals) of each launch a chunk
        makes: one here, one per repetition shard of a mesh."""
        return [(state, self.consts, self.spec, props)]

    def _launch_shape(self, state, consts, spec, props) -> dict:
        """The launch shape of the kernel a chunk of *state* launches,
        after the eager work before a segment's launch (the segment's
        candidates and their factors or rows)."""
        if not self.runs_prefetch:
            return mc_kernel.launch_shape(state, consts, spec)
        cands = mc_kernel.segment_candidates(state, 0, spec, props)
        if self.prefetch_entry == "table":
            mc_kernel.table_factors(spec, cands)
            return mc_kernel.prefetch_launch_shape(state, consts, spec,
                                                   cands)
        return mc_kernel.prefetch_launch_shape(
            state, consts, spec, cands, mc_kernel.segment_rows(spec, cands))

    # --------------------------------------------------------------- run
    def _read(self, state, guard) -> torch.Tensor:
        """What the host reads once a chunk, in one transfer:
        :func:`chunk_vectors` of the state."""
        return chunk_vectors(state, guard)

    def _issue(self, state, ri: int, guard, reads: "_HostReads"):
        """Issues one chunk and, behind it in the stream, the copy of what
        the host reads of it; returns (state, cursor, the posted read)."""
        state, ri = self._chunk(state, ri)
        return state, ri, reads.post(self._read(state, guard))

    def _may_issue_ahead(self, running: np.ndarray,
                         n_iter: np.ndarray) -> bool:
        """True when the chunk after next may be issued before the next
        read, which then cannot ask for a retry (whose fresh batch comes
        from the same generator): on an engine of prefetch segments, where
        every repetition the read just taken found running (so with a
        finite χ² and an advancing counter: else it is stuck) has more
        than one segment's proposals left before max_iterations, and where
        the kernels' float32 test of the criterion agrees with the host's
        (a χ² between the two would look running here and stall on the
        card).  A K1 chunk's seed waits on the card anyway: it runs in
        series."""
        crit = float(self.cfg.convergence_criterion)
        if not self.runs_prefetch or float(np.float32(crit)) != crit:
            return False
        room = (min(int(self.cfg.max_iterations), 2 ** 31 - 1)
                - self.seg_steps * self.cfg.candidates_per_step)
        return bool((n_iter[running] < room).all())

    def _retry(self, state, need_retry: np.ndarray):
        """The state with the repetitions of *need_retry* (R,) started
        afresh (the whole batch is drawn, as every retry draws it)."""
        mask = torch.as_tensor(need_retry, device=self.device)
        return state.merge(self._init_batch(), mask)

    def _host_state(self, state) -> dict:
        """The state's fields but the bank, as host numpy arrays."""
        return {k: v for k, v in state_to_numpy(state).items()
                if k != "ibank"}

    def run(self, stop: Optional[Callable[[], bool]] = None,
            progress: Optional[Callable[[dict], None]] = None
            ) -> EngineResult:
        """Runs the MC optimization, retries included.

        *stop* is polled between chunks for a cooperative abort
        (reference stop flag: mcsas.py:240-245,357); *progress* receives
        the per-rep χ², counters and attempts after every chunk."""
        with profiling.span("core.engine.mc"):
            return self._run(stop, progress)

    def _run(self, stop, progress) -> EngineResult:
        """:meth:`run`'s body, inside its ``core.engine.mc`` span.

        One segment of lookahead: where :meth:`_may_issue_ahead` allows
        it, segment n+1 is issued (drawn and launched) before the host
        waits for read n, so that the host's work runs while segment n
        does; elsewhere the chunks run in series.  Either way the
        generator is called in the same order, ``stop`` is polled once a
        chunk before the next one is issued and ``progress`` sees every
        read, so the result is the serial run's bit for bit.  Counters
        ``core.engine.lookahead.ahead`` and ``.held`` (chunks issued
        before and after the previous read) and ``.spent`` (a segment
        issued ahead on an ensemble that the read then found finished)."""
        cfg = self.cfg
        n_reps = cfg.num_reps
        self.gen.manual_seed(cfg.seed)
        attempts = np.ones(n_reps, dtype=np.int64)
        max_attempts = cfg.max_retries + 2   # reference retry budget
        retried_iters = 0
        t0 = time.perf_counter()

        guard = profiling.guard_flags()
        reads = _HostReads()
        with profiling.span("core.engine.init"):
            state = self._init_batch()
        ri = 0
        prev_iter = None
        n_chunks = rep_chunks = 0
        n_live = n_reps     # repetitions running when the next chunk starts
        ahead = None        # the read of a segment issued ahead of a read
        may_go_ahead = False
        while True:
            with profiling.span("core.engine.chunk"):
                if ahead is None:
                    state, ri, posted = self._issue(state, ri, guard, reads)
                    profiling.count("core.engine.lookahead.held")
                else:
                    posted, ahead = ahead, None
                polled = may_go_ahead
                if polled:
                    stopped = stop is not None and stop()
                    if not stopped:
                        # the segment rewrites ft from the bank even where
                        # nothing runs: kept for a spent one
                        ft_kept = state.ft.clone()
                        state, ri, ahead = self._issue(state, ri, guard,
                                                       reads)
                        profiling.count("core.engine.lookahead.ahead")
                n_chunks += 1
                rep_chunks += n_live
                with profiling.span("core.engine.read"):
                    host = reads.take(posted)
                conval = host[0]
                n_iter = host[1].astype(np.int64)
                if guard:
                    _raise_guarded(host[2], n_chunks, guard)
                converged = conval <= cfg.convergence_criterion
                # non-finite χ² or a stalled counter can never converge:
                # treat as an exhausted attempt so the retry/abort budget
                # applies instead of looping forever (converged reps
                # freeze their counter legitimately and are excluded)
                stuck = ~np.isfinite(conval)
                if prev_iter is not None:
                    stuck |= (n_iter == prev_iter) & ~converged
                prev_iter = n_iter.copy()
                if stuck.any():
                    log.warning("%d repetition(s) made no progress "
                                "(non-finite chi2 or stalled proposals)",
                                int(stuck.sum()))
                exhausted = (n_iter >= cfg.max_iterations) | stuck
                running = ~converged & ~exhausted
                if progress is not None:
                    progress(dict(conval=conval, n_iter=n_iter,
                                  converged=converged, attempts=attempts))
                if not polled:
                    stopped = stop is not None and stop()
                need_retry = (~converged & exhausted
                              & (attempts < max_attempts))
            if stopped:
                log.warning("stop requested, exiting MC loop")
                break
            n_live = int((running | need_retry).sum())
            may_go_ahead = False
            if need_retry.any():
                retried_iters += int(n_iter[need_retry].sum())
                profiling.count("core.engine.retried_reps",
                                int(need_retry.sum()))
                with profiling.span("core.engine.retry"):
                    state = self._retry(state, need_retry)
                attempts[need_retry] += 1
                prev_iter = None   # fresh attempt: counters restart
                log.warning("%d repetition(s) did not converge within "
                            "max_iterations; retrying (attempt %d/%d)",
                            int(need_retry.sum()),
                            int(attempts[need_retry].max()), max_attempts)
                continue
            if not running.any():
                if ahead is not None:
                    # the segment issued ahead found nothing running and
                    # changed nothing but ft
                    state.ft.copy_(ft_kept)
                    profiling.count("core.engine.lookahead.spent")
                # what is neither converged nor retried has spent its
                # last attempt
                if not converged.all():
                    profiling.count("core.engine.unconverged_reps",
                                    int((~converged).sum()))
                break
            may_go_ahead = self._may_issue_ahead(running, n_iter)

        with profiling.span("core.engine.result"):
            host = {k: np.asarray(v, np.float64)
                    for k, v in self._host_state(state).items()}
            elapsed = time.perf_counter() - t0
            conval = host["conval"]
            n_iter = host["n_iter"].astype(np.int64)
            # a cooperative abort only interrupts still-running
            # repetitions; any repetition whose χ² already reached the
            # criterion genuinely converged and is reported as such
            converged = conval <= cfg.convergence_criterion
            total_iters = retried_iters + int(n_iter.sum())
            n_moves = host["n_moves"].astype(np.int64)
            measval = host["scale"][:, None] * host["ft"] \
                + host["background"][:, None]
            return EngineResult(
                contribs=host["rset"],
                conval=conval,
                n_iter=n_iter,
                n_moves=n_moves,
                attempts=attempts,
                converged=converged,
                scaling=host["scale"] / self.w_ref,
                background=host["background"],
                measval=measval,
                w_ref=self.w_ref,
                elapsed=elapsed,
                iters_per_sec=total_iters / max(elapsed, 1e-9),
                moves_per_sec=int(n_moves.sum()) / max(elapsed, 1e-9),
                total_iters=total_iters,
                used_pallas=self.runs_cuda_kernel,
                used_table=self.uses_table,
                used_prefetch=self.runs_cuda_kernel and self.runs_prefetch,
                n_chunks=n_chunks,
                rep_chunks=rep_chunks,
                retried_iters=retried_iters,
            )
