# -*- coding: utf-8 -*-
"""Parameter-grid form-factor row tables: fit-grade evaluation for
quadrature-heavy models (the JAX package's mcsas_tpu/ops/tables.py).

The orientation/propagator integrals of the quadrature models cost ~100
transcendental nodes per proposal row.  The MC hot loop never needs to
re-integrate: the converged integral is evaluated ONCE per engine over a
log-spaced grid of the active size parameters — with the fit-grid q axis
exact — and each proposal's row becomes a multilinear blend of 2^P table
rows.

Accuracy contract: the same "fit-grade" tier as ``ff_fast``; the float32
MC loop trades ~1e-3 kernel accuracy for throughput, and all float64
analysis (post pass, final scaling) re-evaluates the exact ``ff``.

A row function here is batched: ``row_fn(vals (B, P)) -> (B, Nq)``.  The
bake runs blockwise on the engine's device; built tables are memoized per
process (keyed on grids AND the bound model's fixed parameter values, as
in the JAX package, plus the device) and, opt-in, on disk in the JAX
package's npz format.
"""
from __future__ import annotations

import hashlib
import logging
import os
import tempfile
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling

log = logging.getLogger(__name__)


def grid_fingerprint(q_grid) -> str:
    """Collision-safe cache-key fingerprint of a q grid: digest of the
    full float64 byte content."""
    return hashlib.sha1(
        np.ascontiguousarray(np.asarray(q_grid, np.float64)).tobytes()
    ).hexdigest()


def cap_res(res: tuple) -> tuple:
    """Applies the MCSAS_TPU_TABLE_RES_CAP env override (tests shrink the
    one-time table build; production keeps the model defaults)."""
    cap = int(os.environ.get("MCSAS_TPU_TABLE_RES_CAP", "0") or 0)
    if cap > 0:
        return tuple(min(int(r), cap) for r in res)
    return res


def smear_fingerprint(smear) -> tuple:
    """Cache-key fingerprint of a smearing contraction (locs grid +
    weight vector); None stays None (unsmeared tables)."""
    if smear is None:
        return None
    locs, sw = smear
    return (grid_fingerprint(np.asarray(locs).ravel()),
            grid_fingerprint(np.asarray(sw).ravel()))


def log_grid(lo: float, hi: float, n: int) -> np.ndarray:
    """Log-spaced grid; degenerate ranges widen to a factor-2 bracket so
    the interpolation stays well-defined."""
    lo = max(float(lo), 1e-300)
    hi = max(float(hi), lo)
    if hi / lo < 1.0001:
        lo, hi = lo / 2.0, hi * 2.0
    return np.geomspace(lo, hi, n)


class ParamTable(NamedTuple):
    """Rows of a function f(params, q_grid) over a log-spaced parameter
    grid, with the fit-grid q axis exact (no q interpolation).

    ``values[flat(j1..jP)] = f((exp(l0_k + j_k*dl_k))_k, q_grid)``, the
    last axis fastest."""
    values: torch.Tensor                   # (n_rows, Nq)
    axes: tuple                            # ((l0, dl, n), ...) per param

    @property
    def n_q(self) -> int:
        return self.values.shape[1]


def table_from_numpy(values, axes, device="cpu",
                     dtype=torch.float32) -> ParamTable:
    """A ParamTable from host arrays — e.g. the values and axes of a table
    the JAX package baked (its ``ParamTable`` fetched to numpy)."""
    axes = tuple((float(l0), float(dl), int(n))
                 for l0, dl, n in np.asarray(axes, np.float64))
    vals = torch.tensor(np.asarray(values), dtype=dtype, device=device)
    return ParamTable(values=vals, axes=axes)


# ---------------------------------------------------------------- caches

_TABLE_CACHE: dict = {}
_DECLINED = "__table_declined__"


def _disk_cache_path(key):
    """Opt-in persistent table cache (MCSAS_TPU_TABLE_CACHE_DIR): baked
    tables are pure functions of their cache key."""
    d = os.environ.get("MCSAS_TPU_TABLE_CACHE_DIR", "")
    if not d:
        return None
    digest = hashlib.sha1(repr(key).encode()).hexdigest()
    return os.path.join(d, f"table-{digest}.npz")


def _disk_cache_load(path, device, dtype):
    if path is None or not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            values, axes = z["values"], z["axes"]
        return table_from_numpy(values, axes, device, dtype)
    except (OSError, EOFError, KeyError, ValueError,
            zipfile.BadZipFile) as e:             # corrupt entry: rebuild
        log.warning("ignoring unreadable table cache entry %s: %s", path, e)
        return None


def _disk_cache_store(path, table: ParamTable):
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # np.savez appends ".npz" unless the name already ends with it,
        # so the temp name keeps the suffix for the atomic publish
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp.npz")
        os.close(fd)
        np.savez(tmp, values=table.values.cpu().numpy(),
                 axes=np.asarray(table.axes, np.float64))
        os.replace(tmp, path)               # atomic publish
    except OSError as e:                    # the cache is best-effort only
        log.warning("could not store table cache entry %s: %s", path, e)


# ------------------------------------------------------------------ bake

def _eval_blocks(row_fn, pts: np.ndarray, dtype, device,
                 block: int) -> torch.Tensor:
    """row_fn over the rows of *pts* (n, P), *block* rows per call."""
    out = []
    with torch.no_grad():
        for i in range(0, len(pts), block):
            vals = torch.tensor(pts[i:i + block], dtype=dtype, device=device)
            out.append(row_fn(vals).to(dtype))
    return torch.cat(out, dim=0)


def build_param_table(row_fn, grids, dtype=torch.float32, block: int = 256,
                      cache_key=None, probe: bool = False,
                      probe_rows_are_intensity: bool = False,
                      device="cpu"):
    """Evaluates the batched ``row_fn(vals (B, P)) -> (B, Nq)`` over the
    cartesian product of the log-spaced *grids*, *block* rows at a time
    on *device*.

    *cache_key* memoizes the built table within the process.  With
    ``probe=True`` the bake is gated by the interpolation-soundness probe
    and returns **None** when production-spacing interpolation of this row
    function cannot meet the fit-grade contract; declines are memoized per
    cache key.
    """
    grids = [np.asarray(g, np.float64) for g in grids]
    device = torch.device(device)
    key = disk_path = None
    if cache_key is not None:
        # the probe outcome is part of the cache identity (a table baked
        # with the probe bypassed is never served to a probe-gated caller)
        mode = os.environ.get("MCSAS_TPU_TABLE_PROBE", "")
        probe_tag = f"probe:{mode}" if (probe and mode != "off") else ""
        key = (cache_key, tuple((len(g), float(g[0]), float(g[-1]))
                                for g in grids),
               str(dtype).replace("torch.", ""), probe_tag)
        hit = _TABLE_CACHE.get((key, str(device)))
        if hit is not None:
            profiling.count("ops.tables.memo_hit")
            return None if hit is _DECLINED else hit
        disk_path = _disk_cache_path(key)
        hit = _disk_cache_load(disk_path, device, dtype)
        if hit is not None:
            profiling.count("ops.tables.disk_hit")
            _TABLE_CACHE[(key, str(device))] = hit
            return hit
    if probe:
        errs = probe_interp_errors(row_fn, grids, dtype, device=device,
                                   rows_are_intensity=probe_rows_are_intensity)
        if not probe_is_fit_grade(errs):
            log.info("param table declined by interpolation probe (median "
                     "%.2g, p90 %.2g vs contract %g/%g at 2x margin) — "
                     "falling back to in-loop quadrature",
                     float(np.median(errs)), float(np.percentile(errs, 90)),
                     FIT_GRADE_MEDIAN, FIT_GRADE_P90)
            if key is not None:
                _TABLE_CACHE[(key, str(device))] = _DECLINED
            return None
    if grids:
        mesh = np.meshgrid(*grids, indexing="ij")
        pts = np.stack([m.ravel() for m in mesh], axis=-1)
    else:
        pts = np.zeros((1, 0))
    profiling.count("ops.tables.bake")
    values = _eval_blocks(row_fn, pts, dtype, device, block)
    axes = []
    for g in grids:
        lg = np.log(g)
        dl = float((lg[-1] - lg[0]) / max(len(g) - 1, 1))
        axes.append((float(lg[0]), dl if dl > 0 else 1.0, len(g)))
    table = ParamTable(values=values.contiguous(), axes=tuple(axes))
    if key is not None:
        _TABLE_CACHE[(key, str(device))] = table
        _disk_cache_store(disk_path, table)
    return table


# ---------------------------------------------------------------- lookup

def lookup_param_table(table: ParamTable, pvals) -> torch.Tensor:
    """Multilinear row blend at parameter values *pvals* (one tensor of
    shape (...) per table axis); returns rows (..., Nq).  Clamped to the
    table domain.

    The operations mirror the JAX lookup one for one: corners are built
    last axis fastest and summed in that order, the index is clipped at
    ``n - 1.000001`` and the gather clamps like ``mode="clip"``.  The
    1e-300 floor is a weak-typed constant there, i.e. 0 in float32, which
    ``clamp_min`` on the tensor's own dtype reproduces.  Offsets and
    spacings are tensors of the table's dtype, so every device performs
    the same IEEE subtraction and division."""
    vals = table.values
    dt, dev = vals.dtype, vals.device
    # numpy's rule: torch.broadcast_shapes imports sympy on its first
    # call, seconds of a new process's first fit
    lead = np.broadcast_shapes(*(tuple(torch.as_tensor(v).shape)
                                 for v in pvals)) if pvals else ()
    idx = torch.zeros(lead, dtype=torch.int64, device=dev)
    corners = [(idx, torch.ones(lead, dtype=dt, device=dev))]
    stride = 1
    for (l0, dl, n), v in zip(reversed(table.axes), reversed(list(pvals))):
        if n == 1:
            continue
        v = torch.as_tensor(v, dtype=dt, device=dev)
        # offset and spacing filled on the device: a copy from the host
        # would wait for the card's stream once an axis and call
        f = (torch.log(torch.clamp_min(v, 1e-300))
             - torch.full((), l0, dtype=dt, device=dev)) \
            / torch.full((), dl, dtype=dt, device=dev)
        f = torch.clamp(f, 0.0, n - 1.000001)
        fl = torch.floor(f)
        i = fl.to(torch.int64)
        w = f - fl
        corners = ([(c + i * stride, cw * (1.0 - w)) for c, cw in corners]
                   + [(c + (i + 1) * stride, cw * w) for c, cw in corners])
        stride *= n
    out = None
    last = vals.shape[0] - 1
    for c, cw in corners:
        row = vals[c.clamp(0, last)] * cw[..., None]
        out = row if out is None else out + row
    return out


def make_lookup(tab_params):
    """Returns ``fn(table, pdict) -> (..., Nq)`` reading the table's
    parameters from a parameter dict (entries of shape (...)).
    ``fn.tab_params`` names them, one per table axis: the prefetch
    kernel's table entry repeats the lookup from them."""
    def fn(table: ParamTable, pdict):
        return lookup_param_table(table, [pdict[n] for n in tab_params])
    fn.tab_params = tuple(tab_params)
    return fn


# ----------------------------------------------------------------- probe

def probe_interp_errors(row_fn, grids, dtype=torch.float32, n_probe: int = 8,
                        seed: int = 7, rows_are_intensity: bool = False,
                        block: int = 64, device="cpu") -> np.ndarray:
    """Bake-time soundness probe: per-element intensity-weighted relative
    errors of PRODUCTION-SPACING multilinear interpolation at *n_probe*
    random off-grid points, measured before paying for the full bake
    (metric |Δff²| / (ff² + 1e-6·rowmax), as in the JAX package)."""
    grids = [np.asarray(g, np.float64) for g in grids]
    if not grids:
        return np.zeros(1)
    rng = np.random.default_rng(seed)
    lgs = [np.log(g) for g in grids]
    pts, corner_sets, weight_sets = [], [], []
    for _ in range(n_probe):
        # an interior point, uniform in log within a random grid cell
        idx = [rng.integers(0, len(g) - 1) if len(g) > 1 else 0
               for g in grids]
        fr = rng.uniform(0.25, 0.75, len(grids))
        lp = [lg[i] + f * (lg[min(i + 1, len(lg) - 1)] - lg[i])
              for lg, i, f in zip(lgs, idx, fr)]
        pts.append(np.exp(lp))
        corners, weights = [[]], [1.0]
        for lg, i, f in zip(lgs, idx, fr):
            if len(lg) == 1:
                corners = [c + [lg[0]] for c in corners]
            else:
                corners = ([c + [lg[i]] for c in corners]
                           + [c + [lg[i + 1]] for c in corners])
                weights = ([w * (1.0 - f) for w in weights]
                           + [w * f for w in weights])
        corner_sets.append(np.exp(np.asarray(corners)))
        weight_sets.append(np.asarray(weights))
    eval_pts = np.concatenate([np.asarray(pts)] + corner_sets, axis=0)
    rows = _eval_blocks(row_fn, eval_pts, dtype, torch.device(device),
                        block).double().cpu().numpy()
    exact_rows, corner_rows = rows[:n_probe], rows[n_probe:]
    errs = []
    off = 0
    for i in range(n_probe):
        ws = weight_sets[i]
        blend = (corner_rows[off:off + len(ws)] * ws[:, None]).sum(axis=0)
        off += len(ws)
        if rows_are_intensity:          # smeared tables store ff²·w
            e2, a2 = exact_rows[i], blend
        else:                           # amplitude rows: compare ff²
            e2, a2 = exact_rows[i] ** 2, blend ** 2
        floor = 1e-6 * max(e2.max(), 1e-300)
        errs.append(np.abs(a2 - e2) / (np.abs(e2) + floor))
    return np.concatenate(errs)


# Fit-grade interpolation contract (the JAX package's accuracy tests assert
# exactly this on random points); the probe applies it with a 2x margin.
FIT_GRADE_MEDIAN = 1e-3
FIT_GRADE_P90 = 5e-2


def probe_is_fit_grade(errs: np.ndarray, margin: float = 2.0) -> bool:
    """True when probe errors meet the fit-grade contract with *margin*.
    MCSAS_TPU_TABLE_PROBE=off bypasses the check, =strict sets margin 1."""
    mode = os.environ.get("MCSAS_TPU_TABLE_PROBE", "")
    if mode == "off":
        return True
    if mode == "strict":
        margin = 1.0
    return bool(np.median(errs) <= FIT_GRADE_MEDIAN / margin
                and np.percentile(errs, 90) <= FIT_GRADE_P90 / margin)


def param_product_range(bound, name_or_value) -> tuple:
    """(lo, hi) of one parameter: its sampling range if active, else the
    fixed value as a degenerate range."""
    if name_or_value in bound.active:
        return bound.ranges[bound.active.index(name_or_value)]
    for n, v in bound.fixed:
        if n == name_or_value:
            return (v, v)
    raise KeyError(name_or_value)
