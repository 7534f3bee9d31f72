# -*- coding: utf-8 -*-
"""SAS measurement data: host-side preprocessing into a frozen dataclass.

The reference implements this as a mutable object graph with callback wiring
(reference: src/mcsas/dataobj/dataobj.py:20-360, dataobj/sasdata.py:29-183,
dataobj/datavector.py:11-156).  Here the whole ingestion pipeline is a pure
host-side computation producing an immutable :class:`SASData`:

raw columns → SI units → uncertainty floor → validity masking → log-spaced
rebinning → optional smearing matrix.  The device only ever sees the frozen
result (q / I / σ and the precomputed smearing contraction).

All arrays here are float64 numpy; the MC engine converts them to torch
tensors of its compute dtype on its device.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .utils import profiling
from .utils.units import (Angle, ScatteringIntensity,
                          ScatteringVector, Unit)

log = logging.getLogger(__name__)


# ------------------------------------------------------------------ smearing

@dataclass(frozen=True)
class SmearingConfig:
    """Base for instrumental smearing configs.

    ``n_steps`` integration points around each q; ``two_d_coll`` selects
    2D-averaged (pinhole-like) data instead of slit-smeared data
    (reference: src/mcsas/dataobj/sasconfig.py:17-38).
    """
    do_smear: bool = False
    n_steps: int = 25
    two_d_coll: bool = False

    def input_valid(self) -> bool:  # pragma: no cover - abstract-ish
        return False

    def _profile(self, q_offset):
        raise NotImplementedError

    def _offsets(self, q) -> np.ndarray:
        raise NotImplementedError

    def prepare(self, q: np.ndarray):
        """Returns (q_offset, weights) integration grid for data grid *q*."""
        q_offset = self._offsets(np.asarray(q, dtype=np.float64))
        return q_offset, self._profile(q_offset)

    def _log_offsets(self, lo, hi):
        """Common log-spaced offset grids: symmetric ±grid+0 for 2D-averaged
        data, one-sided [0]+grid for slit collimation
        (reference: dataobj/sasconfig.py:122-149, 209-233)."""
        n = self.n_steps
        if self.two_d_coll:
            half = np.logspace(math.log10(lo), math.log10(hi),
                               num=int(math.ceil(n / 2.0)))
            return np.concatenate((-half[::-1], [0.0], half))
        grid = np.logspace(math.log10(lo), math.log10(hi), num=n)
        return np.concatenate(([0.0], grid))


@dataclass(frozen=True)
class TrapezoidSmearing(SmearingConfig):
    """Trapezoidal beam-length profile: flat top (umbra), linear flanks out
    to the penumbra (reference: dataobj/sasconfig.py:77-184)."""
    umbra: float = 0.0
    penumbra: float = 0.0

    def input_valid(self) -> bool:
        return self.umbra > 0.0 and self.penumbra > self.umbra

    def _offsets(self, q):
        return self._log_offsets(q.min() / 5.0, self.penumbra / 2.0)

    def _profile(self, x):
        # half-trapezoid PDF mirrored around 0; integral over x>0 is 0.5
        # (van Dorp & Kotz 2003 eq. 1; reference: sasconfig.py:105-120)
        c, d = self.umbra, self.penumbra
        x = np.abs(np.asarray(x, dtype=np.float64))
        pdf = np.zeros_like(x)
        pdf[x < c] = 1.0
        if d > c:
            flank = (c <= x) & (x < d)
            pdf[flank] = (d - x[flank]) / (d - c)
        return pdf / (d + c)


@dataclass(frozen=True)
class GaussianSmearing(SmearingConfig):
    """Gaussian beam profile (reference: dataobj/sasconfig.py:186-260).
    Note: the reference passes ``variance`` as the Gaussian *scale* (σ) of
    ``scipy.stats.norm.pdf``; we keep that behavior for parity."""
    variance: float = 0.0

    def input_valid(self) -> bool:
        return self.variance > 0.0

    def _offsets(self, q):
        return self._log_offsets(q.min() / 3.0, 2.5 * self.variance)

    def _profile(self, x):
        s = self.variance
        return np.exp(-0.5 * (x / s) ** 2) / (s * math.sqrt(2.0 * math.pi))


def _trapz_coeffs(x: np.ndarray) -> np.ndarray:
    """Coefficient vector c with trapz(f, x) == f @ c."""
    dx = np.diff(x)
    c = np.zeros_like(x)
    c[:-1] += 0.5 * dx
    c[1:] += 0.5 * dx
    return c


# ---------------------------------------------------------------- DataConfig

@dataclass(frozen=True)
class DataConfig:
    """Preprocessing settings, the counterpart of the reference's
    DataConfig/SASConfig parameter sets (reference:
    src/mcsas/dataobj/dataconfig.py:73-115, sasconfig.py:262-371)."""
    x0_low: float = 0.0                 # q-limits, SI [m⁻¹]
    x0_high: float = float("inf")
    x1_low: float = -float("inf")       # ψ-limits, SI [rad]
    x1_high: float = float("inf")
    f_mask_zero: bool = False           # drop I == 0
    f_mask_neg: bool = False            # drop I < 0
    fu_min: float = 0.01                # min uncertainty as fraction of I
    n_bin: int = 100                    # ≤0 disables rebinning
    smearing: Optional[SmearingConfig] = None
    # 2D (q, ψ) fitting: keep the per-pixel ψ on the fit grid (disables
    # log rebinning) so ψ-aware models (SASModel.ff2d) fit anisotropic
    # data.  The reference's 2D path is dormant/broken upstream
    # (mcsas.py:617-651 references undefined names); this is a working
    # re-design of that capability.
    fit_2d: bool = False

    def replace(self, **kw) -> "DataConfig":
        return dataclasses.replace(self, **kw)


# ------------------------------------------------------------------- SASData

@dataclass(frozen=True)
class SASData:
    """Frozen, preprocessed small-angle scattering dataset.

    ``q``/``f``/``fu`` are the *fit grid* (binned when binning is on,
    sanitized otherwise) in SI units; these are what the engine and the
    χ² fit consume (the reference equivalents are x0.binnedData,
    f.binnedData, f.binnedDataU).
    """
    title: str
    filename: Optional[str]
    raw: np.ndarray                 # original file columns
    config: DataConfig
    # full-resolution SI channels
    q_si: np.ndarray
    f_si: np.ndarray
    fu_si: np.ndarray
    psi_si: Optional[np.ndarray]
    valid: np.ndarray               # boolean validity mask over q_si
    # fit grid
    q: np.ndarray
    f: np.ndarray
    fu: np.ndarray
    # ψ on the fit grid, aligned with q (only when config.fit_2d and the
    # raw data carries a ψ column; None otherwise)
    psi: Optional[np.ndarray] = None
    # smearing: locs is the (len(q), n_offsets) evaluation grid, and
    # smear_w the contraction vector such that the smeared intensity is
    # (ff(locs)² · w) @ smear_w  (already includes the factor 2 and the
    # beam-profile weights; reference: sasmodel.py:56-73, sasconfig.py:308-339)
    locs: Optional[np.ndarray] = None
    smear_w: Optional[np.ndarray] = None

    # --- derived helpers -------------------------------------------------
    @property
    def count(self) -> int:
        return int(self.q.shape[0])

    @property
    def is2d(self) -> bool:
        return self.psi_si is not None

    @property
    def q_limit(self):
        s = self.q_si[self.valid]
        return (float(s.min()), float(s.max())) if s.size else (0.0, 0.0)

    @property
    def f_limit(self):
        s = self.f_si[self.valid]
        return (float(s.min()), float(s.max())) if s.size else (0.0, 0.0)

    @property
    def spherical_size_estimate(self):
        """π/q sphere-radius range estimate
        (reference: dataobj/sasdata.py:178-183)."""
        lo, hi = self.q_limit
        if lo == 0.0:
            return None
        return (math.pi / hi, math.pi / abs(lo))

    @property
    def shannon_channel_estimate(self) -> Optional[int]:
        lo, hi = self.q_limit
        if lo <= 0.0:
            return None
        return int(hi / lo)

    @property
    def uses_smearing(self) -> bool:
        return self.locs is not None

    def content_key(self) -> str:
        """Collision-safe digest of everything the fit consumes: the fit
        grid, the smearing contraction and the preprocessing config.  Used
        to key executable caches (api.fit engine reuse, the post-pass jit)
        so repeat fits of identical inputs skip re-tracing."""
        memo = self.__dict__.get("_content_key")
        if memo is not None:
            return memo
        import hashlib
        h = hashlib.sha256()
        for arr in (self.q, self.f, self.fu, self.psi, self.locs,
                    self.smear_w):
            if arr is None:
                h.update(b"\x00none")
            else:
                a = np.ascontiguousarray(np.asarray(arr, np.float64))
                h.update(str(a.shape).encode())
                h.update(a.tobytes())
        h.update(repr(self.config).encode())
        key = h.hexdigest()
        object.__setattr__(self, "_content_key", key)
        return key

    def with_config(self, config: DataConfig) -> "SASData":
        return _build(self.title, self.filename, self.raw, config)


def from_raw(raw: np.ndarray, title: str = "", filename: Optional[str] = None,
             config: Optional[DataConfig] = None,
             q_unit: Unit = ScatteringVector("nm⁻¹"),
             i_unit: Unit = ScatteringIntensity("(m sr)⁻¹"),
             psi_unit: Unit = Angle("°")) -> SASData:
    """Builds a SASData from raw file columns q, I[, σI[, ψ]]
    (reference column conventions: src/mcsas/dataobj/sasdata.py:133-159)."""
    with profiling.span("data.from_raw"):
        return _build(title, filename, np.asarray(raw, dtype=np.float64),
                      config or DataConfig(), q_unit, i_unit, psi_unit)


def load(filename, config: Optional[DataConfig] = None, **units) -> SASData:
    from .io import load_raw
    raw, title = load_raw(filename)
    return from_raw(raw, title=title, filename=str(filename), config=config,
                    **units)


def _build(title, filename, raw, config,
           q_unit=ScatteringVector("nm⁻¹"),
           i_unit=ScatteringIntensity("(m sr)⁻¹"),
           psi_unit=Angle("°")) -> SASData:
    if raw.ndim != 2 or raw.shape[1] < 2:
        raise ValueError("raw data must have at least q and I columns")
    q_si = q_unit.to_si(raw[:, 0])
    f_si = i_unit.to_si(raw[:, 1])
    raw_u = raw[:, 2] if raw.shape[1] > 2 else None
    psi_si = None
    if raw.shape[1] > 3 and raw[:, 3].min() != raw[:, 3].max():
        psi_si = psi_unit.to_si(raw[:, 3])

    # uncertainty floor (reference: dataobj/dataobj.py:204-226)
    fu_floor = config.fu_min * f_si
    if raw_u is None:
        fu_si = fu_floor.copy()
    else:
        fu_si = np.maximum(i_unit.to_si(raw_u), fu_floor)
    fu_si = np.where(np.isfinite(fu_si), fu_si, np.inf)

    # validity masking (reference: dataobj/dataobj.py:239-286)
    valid = np.isfinite(f_si)
    if config.f_mask_zero:
        valid &= f_si != 0.0
    if config.f_mask_neg:
        valid &= f_si > 0.0
    valid &= (q_si >= config.x0_low) & (q_si <= config.x0_high)
    if psi_si is not None:
        valid &= (psi_si > config.x1_low) & (psi_si <= config.x1_high)

    san_q, san_f, san_fu = q_si[valid], f_si[valid], fu_si[valid]

    psi_fit = None
    if config.fit_2d and psi_si is not None:
        # 2D fit grid: per-pixel (q, ψ) pairs, no log rebinning
        psi_fit = psi_si[valid]
        qb, fb, fub = san_q, san_f, san_fu
    elif config.n_bin > 0 and san_q.size:
        qb, fb, fub = _rebin_log(san_q, san_f, san_fu, config.n_bin)
    else:
        qb, fb, fub = san_q, san_f, san_fu

    locs = smear_w = None
    sm = config.smearing
    if sm is not None and sm.do_smear and sm.input_valid() and qb.size:
        q_offset, weights = sm.prepare(qb)
        if sm.two_d_coll:
            locs = np.add.outer(qb, q_offset)
        else:  # slit collimation: q ⊕ offsets in quadrature
            locs = np.sqrt(np.add.outer(qb ** 2, q_offset ** 2))
        smear_w = 2.0 * _trapz_coeffs(q_offset) * weights

    return SASData(title=title, filename=filename, raw=raw, config=config,
                   q_si=q_si, f_si=f_si, fu_si=fu_si, psi_si=psi_si,
                   valid=valid, q=qb, f=fb, fu=fub, psi=psi_fit,
                   locs=locs, smear_w=smear_w)


def _rebin_log(q, f, fu, n_bin):
    """Log-spaced rebinning to ≤ n_bin bins; per-bin uncertainty is the max
    of the standard error of the mean and the propagated uncertainty
    (reference: dataobj/dataobj.py:288-345)."""
    edges = np.logspace(np.log10(q.min()),
                        np.log10(q.max() + np.diff(q)[-1] / 100.0),
                        n_bin + 1)
    qb = np.full(n_bin, np.nan)
    fb = np.full(n_bin, np.nan)
    fub = np.full(n_bin, np.nan)
    for i in range(n_bin):
        m = (q >= edges[i]) & (q < edges[i + 1])
        n = int(m.sum())
        if n == 0:
            continue
        if n == 1:
            qb[i], fb[i], fub[i] = q[m][0], f[m][0], fu[m][0]
            continue
        qb[i], fb[i] = q[m].mean(), f[m].mean()
        sem = f[m].std(ddof=1) / math.sqrt(n)
        propagated = math.sqrt((fu[m] ** 2).sum() / n)
        fub[i] = max(sem, propagated)
    keep = ~np.isnan(fb)
    return qb[keep], fb[keep], fub[keep]
