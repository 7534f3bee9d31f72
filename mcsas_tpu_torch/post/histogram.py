# -*- coding: utf-8 -*-
"""Post-fit analysis: fractions, observability limits, histograms, moments.

Reference semantics: McSAS.histogram (src/mcsas/mcsas/mcsas.py:445-615) and
the Histogram/Moments machinery (src/mcsas/utils/parameter.py:20-154,
187-568).  The per-repetition float64 analysis (:func:`_post_pass_f64`)
evaluates the whole (R, N, Nq) partial-intensity bank in torch float64
on the engine's device (for smeared data on the (Nq, n_off) grid of
smearing offsets, in blocks of contributions); fractions, histograms and
moments are numpy on the host, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import McSASConfig
from ..core.fitcore import agofs as agofs_fn
from ..core.fitcore import make_constants, solve_scale_bg
from ..data import SASData
from ..models.base import BoundModel

WEIGHTINGS = ("vol", "num", "int", "surf")
XSCALES = ("lin", "log")


# ------------------------------------------------------------------ specs

@dataclass(frozen=True)
class HistogramSpec:
    """User-configurable histogram over one active parameter
    (reference: utils/parameter.py:187-343)."""
    param: str
    lower: float = None          # SI; None → parameter's active range
    upper: float = None
    bin_count: int = 50
    xscale: str = "lin"          # 'lin' | 'log'
    yweight: str = "vol"         # 'vol' | 'num' | 'int' | 'surf'
    # None (default) → follow the active range unless explicit bounds
    # were given (reference autoFollow, utils/parameter.py:240-247);
    # passing auto_follow=True with explicit bounds deliberately
    # overrides them.  Resolved lazily (not in __post_init__) so
    # ``dataclasses.replace(spec, lower=..., upper=...)`` on a
    # bounds-less spec honors the new bounds.
    auto_follow: bool = None

    def __post_init__(self):
        if self.xscale not in XSCALES:
            raise ValueError(f"xscale must be one of {XSCALES}")
        if self.yweight not in WEIGHTINGS:
            raise ValueError(f"yweight must be one of {WEIGHTINGS}")
        if self.bin_count < 1:
            raise ValueError("bin_count must be >= 1")

    def _follows_active_range(self) -> bool:
        if self.auto_follow is None:
            return self.lower is None and self.upper is None
        return self.auto_follow

    def resolved(self, bound: BoundModel) -> "HistogramSpec":
        if self.param not in bound.active:
            raise KeyError(f"{self.param!r} is not an active parameter")
        lo, hi = bound.ranges[bound.active.index(self.param)]
        auto = self._follows_active_range()
        lower = lo if (self.lower is None or auto) else self.lower
        upper = hi if (self.upper is None or auto) else self.upper
        return dataclasses.replace(self, lower=float(lower),
                                   upper=float(upper), auto_follow=False)


def default_histograms(bound: BoundModel) -> Tuple[HistogramSpec, ...]:
    """One vol-weighted linear 50-bin histogram per active parameter."""
    return tuple(HistogramSpec(param=name).resolved(bound)
                 for name in bound.active)


# ---------------------------------------------------------------- results

@dataclass
class VectorOverReps:
    """Per-repetition vectors plus their mean/sample-std
    (reference VectorResult: utils/parameter.py:156-184)."""
    full: np.ndarray             # (B, R)

    @property
    def mean(self):
        return self.full.mean(axis=1)

    @property
    def std(self):
        ddof = 1 if self.full.shape[1] > 1 else 0
        return self.full.std(axis=1, ddof=ddof)


@dataclass
class Moments:
    """Distribution moments within a range, averaged over repetitions
    (reference: utils/parameter.py:20-122)."""
    total: Tuple[float, float]
    mean: Tuple[float, float]
    variance: Tuple[float, float]
    skew: Tuple[float, float]
    kurtosis: Tuple[float, float]

    FIELD_NAMES = ("totalValue", "totalValueStd", "mean", "meanStd",
                   "variance", "varianceStd", "skew", "skewStd",
                   "kurtosis", "kurtosisStd")

    @property
    def fields(self) -> tuple:
        return (self.total + self.mean + self.variance + self.skew
                + self.kurtosis)


@dataclass
class HistogramResult:
    spec: HistogramSpec
    x_lower_edge: np.ndarray     # (B+1,)
    x_mean: np.ndarray           # (B,)
    x_width: np.ndarray          # (B,)
    bins: VectorOverReps         # (B, R)
    cdf: VectorOverReps          # (B, R)
    observability: np.ndarray    # (B,)
    moments: Moments


@dataclass
class FractionsResult:
    """Per-contribution fractions and observability limits for each
    weighting (reference arrays: mcsas.py:521-609)."""
    fraction: Dict[str, np.ndarray]      # each (N, R)
    min_req: Dict[str, np.ndarray]       # each (N, R)
    total: Dict[str, np.ndarray]         # each (R,)
    scaling: np.ndarray                  # (2, R) [A; b] SI
    volumes: np.ndarray                  # (N, R) absolute volumes
    surfaces: np.ndarray                 # (N, R)
    agofs: np.ndarray                    # (R,) Henn-2016 goodness of fit
    # exact-kernel fitted curve A·I+b per rep (R, Nq) — unlike the
    # engine's measval this is float64 with the full (non-fit-grade) ff
    measval: np.ndarray = None


# ------------------------------------------------------------ computation

# float64 values one block of the bank's evaluation may hold at once (the
# form factor's largest temporary: block × grid points × quadrature nodes;
# 268 MB, and a quadrature model keeps about a dozen alive).  The
# unsmeared suite rows (3000 contributions) stay one block.
BANK_BLOCK_VALUES = 2 ** 25


def _bank_f64(bound: BoundModel, data: SASData, comp2: float,
              rset: torch.Tensor, block: Optional[int] = None
              ) -> torch.Tensor:
    """The float64 partial-intensity bank (R, N, Nq) of contributions
    *rset* (R, N, P): ff²·w on the fit grid, or for smeared data
    (ff²(locs) @ smear_w)·w on the (Nq, n_off) grid of smearing offsets
    (reference: sasmodel.py:56-73), with w = volume^comp2.

    Evaluated *block* contributions at a time, so that the temporaries
    (block × Nq × n_off × the model's quadrature nodes) stay bounded: a
    smeared cylinder's whole bank would take gigabytes per temporary.
    *block* None sizes the blocks to :data:`BANK_BLOCK_VALUES`; the
    result does not depend on it (each contribution's row is its own)."""
    model, dev = bound.model, rset.device
    smearing = data.uses_smearing and model.can_smear
    grid = torch.as_tensor(np.asarray(data.locs if smearing else data.q,
                                      np.float64)).to(dev)
    smear_w = (torch.as_tensor(np.asarray(data.smear_w, np.float64)).to(dev)
               if smearing else None)
    flat = rset.reshape(-1, rset.shape[-1])
    if block is None:
        nodes = 1 if model.elementwise_q else int(
            dict(bound.fixed).get("intDiv", 1))
        block = max(1, BANK_BLOCK_VALUES // (grid.numel() * max(nodes, 1)))
    out = []
    for i in range(0, len(flat), block):
        part = flat[i:i + block]
        # entries (B, 1) against the fit grid, (B, 1, 1) against locs
        pd = bound.pdict(part[:, None, None, :] if smearing
                         else part[:, None, :])
        ffv = model.ff(grid, pd)
        it = (ffv * ffv) @ smear_w if smearing else ffv * ffv
        w = model.volume(bound.pdict(part[:, None, :])) ** comp2
        out.append(it * w)
    return torch.cat(out).reshape(*rset.shape[:2], -1)


def _post_pass_f64(bound: BoundModel, data: SASData, cfg: McSASConfig,
                   contribs: np.ndarray, device="cpu",
                   bank_block: Optional[int] = None):
    """The whole per-repetition float64 analysis on *device*:
    per-contribution properties, the bank (:func:`_bank_f64`, in blocks
    of *bank_block* contributions), the scale/background solve, fitted
    curves, aGoFs and the observability min-ratio (reference equivalent:
    the per-contribution Python loops of mcsas.py:549-594).  Returns
    numpy float64 arrays (wset, vset, sset (R, N), a, b (R,), measval
    (R, Nq), agofs (R,), minq (R, N))."""
    if data.psi is not None and bound.model.ff2d is not None:
        raise NotImplementedError(
            "2D (q, psi) post analysis is not ported to PyTorch yet")
    f64 = torch.float64
    comp2 = 2.0 * cfg.compensation_exponent
    n_params = contribs.shape[2]
    rset = torch.as_tensor(np.asarray(contribs, np.float64)).to(device)
    model = bound.model

    def props(pd):
        return (model.volume(pd) ** comp2, model.absvolume_fn()(pd),
                model.surface(pd))

    bank = _bank_f64(bound, data, comp2, rset, bank_block)
    shape = rset.shape[:2]
    wset, vset, sset = (
        torch.broadcast_to(torch.as_tensor(v, dtype=f64, device=device),
                           shape)
        for v in props(bound.pdict(rset)))
    consts = make_constants(data.f, data.fu, f64, device)
    sigma_raw = torch.as_tensor(np.asarray(data.fu, np.float64)).to(device)

    ft = bank.sum(dim=1)                                 # (R, Nq)
    # normalize before solving — keeps the scale-invariant degeneracy
    # guards of solve_scale_bg honest at SI magnitudes (~1e-30); the
    # fitted scale reverts the factor exactly
    ft_norm = torch.clamp_min(ft.abs().amax(dim=-1), 1e-300)
    sol = solve_scale_bg(ft / ft_norm[:, None], consts, cfg.find_background,
                         cfg.positive_background)
    a = sol.scale / ft_norm
    b = sol.background
    measval = a[:, None] * ft + b[:, None]
    # alternative goodness-of-fit [Henn 2016]
    ag = agofs_fn(ft, a[:, None], b[:, None], consts, n_params)
    # observability: min over q of σ/I_partial — the solve scale in the
    # reference's σ·vf/(A·I_partial) cancels against the one in
    # vf = w·A/v (mcsas.py:574-594); multiplied back by w/v per
    # weighting in compute_fractions
    pos = bank > 0.0
    ratio = torch.where(pos, sigma_raw / torch.where(pos, bank, 1.0),
                        torch.full_like(bank, float("inf")))
    minq = ratio.amin(dim=-1)                            # (R, N)
    return tuple(t.cpu().numpy() for t in
                 (wset, vset, sset, a, b, measval, ag, minq))


def compute_fractions(contribs: np.ndarray, data: SASData,
                      bound: BoundModel, cfg: McSASConfig, device="cpu"
                      ) -> FractionsResult:
    """Volume/number/intensity/surface fractions, totals, observability
    limits and per-rep scaling — reference mcsas.py:549-609."""
    n_reps, n, _ = contribs.shape
    frac = {w: np.zeros((n, n_reps)) for w in WEIGHTINGS}
    minr = {w: np.zeros((n, n_reps)) for w in WEIGHTINGS}
    total = {w: np.zeros(n_reps) for w in WEIGHTINGS}
    (wsets, vsets, ssets, a_arr, b_arr, measval, agofs,
     minqs) = _post_pass_f64(bound, data, cfg, contribs, device)
    scaling = np.stack([a_arr, b_arr])                     # (2, R)
    volumes = vsets.T.copy()                               # (N, R)
    surfaces = ssets.T.copy()

    for ri in range(n_reps):
        wset, vset, sset = wsets[ri], vsets[ri], ssets[ri]
        a = a_arr[ri]

        # fractions (mcsas.py:565-572); weights revert the intensity
        # normalization through the scaling, volumes stay absolute
        vf = wset * a / vset
        nf = vf / vset
        isf = vf * vset
        sf = nf * sset
        frac["vol"][:, ri] = vf
        frac["num"][:, ri] = nf
        frac["int"][:, ri] = isf
        frac["surf"][:, ri] = sf
        total["vol"][ri] = vf.sum()
        total["num"][ri] = nf.sum()
        total["int"][ri] = isf.sum()
        total["surf"][ri] = sf.sum()

        # observability limits per weighting (mcsas.py:574-594)
        mrv = (wset / vset) * minqs[ri]
        minr["vol"][:, ri] = mrv
        minr["num"][:, ri] = mrv / vset
        minr["int"][:, ri] = (mrv / vset) * mrv * mrv
        minr["surf"][:, ri] = (mrv / vset) * sset

        # number/int/surface normalized to totals (mcsas.py:596-604)
        for w in ("num", "int", "surf"):
            if total[w][ri] != 0.0:
                frac[w][:, ri] /= total[w][ri]
                minr[w][:, ri] /= total[w][ri]

    return FractionsResult(fraction=frac, min_req=minr, total=total,
                           measval=measval,
                           scaling=scaling, volumes=volumes,
                           surfaces=surfaces, agofs=agofs)


def _edges(spec: HistogramSpec) -> np.ndarray:
    if spec.xscale == "lin":
        return np.linspace(spec.lower, spec.upper, spec.bin_count + 1)
    return np.logspace(math.log10(spec.lower), math.log10(spec.upper),
                       spec.bin_count + 1)


def _moments(values: np.ndarray, fraction: np.ndarray,
             lower: float, upper: float) -> Moments:
    """Weighted moments per rep, then mean±std over reps
    (reference: utils/parameter.py:80-122)."""
    n, n_reps = values.shape
    out = np.zeros((5, n_reps))
    for ri in range(n_reps):
        v, f = values[:, ri], fraction[:, ri]
        m = (v > lower) & (v < upper)
        if not m.any():
            continue
        v, f = v[m], f[m]
        tot = f.sum()
        out[0, ri] = tot
        mu = (v * f).sum() / tot if tot != 0 else (v * f).sum()
        out[1, ri] = mu
        var = ((v - mu) ** 2 * f).sum() / tot if tot != 0 else 0.0
        out[2, ri] = var
        sig = math.sqrt(abs(var))
        if tot * sig == 0.0:
            continue
        out[3, ri] = ((v - mu) ** 3 * f).sum() / (tot * sig ** 3)
        out[4, ri] = ((v - mu) ** 4 * f).sum() / (tot * sig ** 4)
    ddof = 1 if n_reps > 1 else 0
    pairs = [(out[i].mean(), out[i].std(ddof=ddof)) for i in range(5)]
    return Moments(total=pairs[0], mean=pairs[1], variance=pairs[2],
                   skew=pairs[3], kurtosis=pairs[4])


def compute_histogram(spec: HistogramSpec, contribs: np.ndarray,
                      bound: BoundModel,
                      fractions: FractionsResult) -> HistogramResult:
    """Bins one parameter's contribution values under one weighting
    (reference: utils/parameter.py:420-479)."""
    pi = bound.active.index(spec.param)
    values = contribs[:, :, pi].T          # (N, R)
    frac = fractions.fraction[spec.yweight]
    minreq = fractions.min_req[spec.yweight]
    n, n_reps = values.shape
    b = spec.bin_count
    edges = _edges(spec)

    # vectorized masked segment sums over (bin, rep) — the reference
    # loops per repetition per bin (utils/parameter.py:440-479), which
    # crawls at the 1e6-contribution scale the reference nominally allows
    idx = np.digitize(values, edges) - 1               # (N, R)
    in_range = (idx >= 0) & (idx < b)
    rep_ix = np.broadcast_to(np.arange(n_reps), (n, n_reps))
    flat = (rep_ix * b + np.clip(idx, 0, b - 1))[in_range]
    size = b * n_reps

    def segsum(w):
        return np.bincount(flat, weights=w[in_range],
                           minlength=size).reshape(n_reps, b).T

    bins = np.nan_to_num(segsum(frac), nan=0.0)
    counts = np.bincount(flat, minlength=size).reshape(n_reps, b).T
    with np.errstate(invalid="ignore"):
        obs = np.where(counts > 0,
                       segsum(minreq) / np.maximum(counts, 1), 0.0)
    c = np.cumsum(bins, axis=0)
    last = np.where(c[-1] != 0.0, c[-1], 1.0)
    cdf = np.where(c[-1] != 0.0, c / last, 0.0)

    # observability: per-bin max over reps, ignoring infs
    # (reference: utils/parameter.py:398-409)
    obs_f = np.where(obs < np.inf, obs, -np.inf)
    mx = obs_f.max(axis=1, initial=-np.inf)
    observability = np.where(np.isfinite(mx), mx, 0.0)

    return HistogramResult(
        spec=spec,
        x_lower_edge=edges,
        x_mean=0.5 * (edges[:-1] + edges[1:]),
        x_width=np.diff(edges),
        bins=VectorOverReps(bins),
        cdf=VectorOverReps(cdf),
        observability=observability,
        moments=_moments(values, frac, spec.lower, spec.upper),
    )


def histogram_all(contribs: np.ndarray, data: SASData, bound: BoundModel,
                  cfg: McSASConfig,
                  specs: Optional[Sequence[HistogramSpec]] = None,
                  device="cpu"):
    """Full post-fit pipeline: fractions once, then every histogram.

    *contribs* has shape (R, N, P) — e.g. ``EngineResult.contribs`` or a
    stored contributions array for re-analysis; the float64 bank is
    evaluated on *device*.
    """
    specs = (default_histograms(bound) if specs is None
             else tuple(s.resolved(bound) for s in specs))
    fractions = compute_fractions(contribs, data, bound, cfg, device)
    results = [compute_histogram(s, contribs, bound, fractions)
               for s in specs]
    return fractions, results
