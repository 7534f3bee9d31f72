# -*- coding: utf-8 -*-
"""Headless user API: fit a dataset and inspect the result::

    result = fit(data, model="Sphere", cfg=McSASConfig(...), device="cuda")

Replaces the reference's GUI-driven Calculator orchestration
(src/mcsas/gui/calc.py:219-331) with a pure function.  The compute device
is explicit: ``device="cuda"`` (the default) raises when there is no card.
"""
from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from . import data as data_mod
from .config import McSASConfig
from .core.engine import EngineResult, McSASEngine
from .data import SASData
from .models import get_model
from .models.base import BoundModel, SASModel
from .post.histogram import (FractionsResult, HistogramSpec,
                             histogram_all)

log = logging.getLogger(__name__)


@dataclass
class McSASResult:
    """Complete result of one MC fit (reference result-dict fields:
    mcsas.py:264-285 docstring at :54-132)."""
    data: SASData
    bound: BoundModel
    cfg: McSASConfig
    engine: EngineResult
    fractions: FractionsResult
    histograms: list            # list[HistogramResult]
    device: torch.device = torch.device("cpu")   # where the post pass ran

    # --- common-result accessors (reference naming) ---------------------
    @property
    def contribs(self) -> np.ndarray:
        """(numContribs, numParams, numReps) — reference layout."""
        return np.transpose(self.engine.contribs, (1, 2, 0))

    @property
    def fit_x0(self) -> np.ndarray:
        return self.data.q

    @property
    def _measval(self) -> np.ndarray:
        """Fitted curve per rep: the float64 exact-kernel curve from the
        post pass when available (the engine's is float32)."""
        mv = getattr(self.fractions, "measval", None)
        return mv if mv is not None else self.engine.measval

    @property
    def fit_measval_mean(self) -> np.ndarray:
        return self._measval.mean(axis=0)

    @property
    def fit_measval_std(self) -> np.ndarray:
        return self._measval.std(axis=0)

    @property
    def scaling(self):
        s = self.engine.scaling
        return (s.mean(), s.std(ddof=1 if len(s) > 1 else 0))

    @property
    def background(self):
        b = self.engine.background
        return (b.mean(), b.std(ddof=1 if len(b) > 1 else 0))

    @property
    def times(self):
        return self.engine.elapsed

    @property
    def num_iter(self):
        return self.engine.n_iter.mean()

    @property
    def converged(self) -> bool:
        return bool(self.engine.converged.all())

    def histogram(self, specs: Sequence[HistogramSpec]):
        """Re-histograms the stored contributions without re-fitting
        (reference re-analysis path: mcsas.py:445,513-514)."""
        fractions, hists = histogram_all(self.engine.contribs, self.data,
                                         self.bound, self.cfg, specs,
                                         device=self.device)
        return McSASResult(data=self.data, bound=self.bound, cfg=self.cfg,
                           engine=self.engine, fractions=fractions,
                           histograms=hists, device=self.device)

    def regenerate_measval(self, full_grid: bool = True) -> np.ndarray:
        """Regenerates the rep-averaged fitted intensity on the full
        (unbinned) measurement grid, in float64, and embeds it back into
        the raw row layout — NaN on masked-out rows."""
        q = self.data.q_si[self.data.valid] if full_grid else self.data.q
        comp2 = 2.0 * self.cfg.compensation_exponent
        model = self.bound.model
        rset = torch.as_tensor(np.asarray(self.engine.contribs, np.float64))
        pd = self.bound.pdict(rset[..., None, :])
        ffv = model.ff(torch.as_tensor(np.asarray(q, np.float64)), pd)
        curves = (ffv * ffv * model.volume(pd) ** comp2).sum(dim=1).numpy()
        avg = (self.engine.scaling[:, None] * curves
               + self.engine.background[:, None]).mean(axis=0)
        if not full_grid:
            return avg
        out = np.full(self.data.q_si.shape, np.nan)
        out[self.data.valid] = avg
        return out


def _resolve_model(model) -> BoundModel:
    if isinstance(model, BoundModel):
        return model
    if isinstance(model, SASModel):
        return model.bind()
    if isinstance(model, str):
        return get_model(model).bind()
    if model is None:
        log.info("No model provided, defaulting to Sphere "
                 "(reference fallback: mcsas.py:156-165)")
        return get_model("Sphere").bind()
    raise TypeError(f"cannot interpret {model!r} as a model")


def _default_unbounded_ranges(bound: BoundModel, data: SASData
                              ) -> BoundModel:
    """Replaces non-finite active sampling ranges with the π/q size
    estimate of the data — the reference GUI's 'copy sphere size
    estimates to the model' behavior (doc/source/quickstart.rst step 2).
    Several reference models declare open-ended value ranges and rely on
    the user setting finite limits; sampling from them would propose
    inf."""
    bad = [i for i, (lo, hi) in enumerate(bound.ranges)
           if not (math.isfinite(lo) and math.isfinite(hi))]
    if not bad:
        return bound
    est = data.spherical_size_estimate
    if est is None:
        raise ValueError(
            "active parameter range is unbounded and the data provides "
            "no size estimate; pass active_ranges to bind()")
    overrides = {}
    for i in bad:
        name = bound.active[i]
        lo, hi = bound.ranges[i]
        overrides[name] = (max(lo, est[0]) if math.isfinite(lo) else est[0],
                           est[1])
        log.info("active range of %r was unbounded; defaulting to the "
                 "data size estimate [%.3g, %.3g]", name, *overrides[name])
    return bound.model.bind(active=bound.active,
                            active_ranges={
                                **{n: r for n, r in
                                   zip(bound.active, bound.ranges)},
                                **overrides},
                            fixed=dict(bound.fixed))


def fit(data: Union[SASData, str, os.PathLike],
        model=None,
        cfg: Optional[McSASConfig] = None,
        histograms: Optional[Sequence[HistogramSpec]] = None,
        stop: Optional[Callable[[], bool]] = None,
        progress: Optional[Callable[[dict], None]] = None,
        device="cuda") -> McSASResult:
    """Runs the full MC analysis on one dataset.

    - *data*: a SASData or a path to a data file
    - *model*: model name, SASModel, or BoundModel (default Sphere)
    - *cfg*: algorithm settings (defaults mirror the reference JSON)
    - *histograms*: histogram specs (default: one per active parameter)
    - *stop*: callable polled between chunks for cooperative abort
      (reference stop flag: mcsas.py:240-245,357)
    - *progress*: callable receiving per-rep χ² and counters per chunk
    - *device*: where the MC loop and the float64 post pass run; "cuda"
      raises when torch.cuda.is_available() is False
    """
    if not isinstance(data, SASData):
        data = data_mod.load(data)
    bound = _resolve_model(model)
    bound = _default_unbounded_ranges(bound, data)
    cfg = cfg or McSASConfig()
    engine = McSASEngine(data, bound, cfg, device=device)
    eng_result = engine.run(stop=stop, progress=progress)
    if not eng_result.converged.all() and not cfg.show_incomplete:
        log.warning(
            "%d of %d repetitions did not reach the convergence criterion",
            int((~eng_result.converged).sum()), cfg.num_reps)
    fractions, hists = histogram_all(eng_result.contribs, data, bound, cfg,
                                     histograms, device=engine.device)
    return McSASResult(data=data, bound=bound, cfg=cfg, engine=eng_result,
                       fractions=fractions, histograms=hists,
                       device=engine.device)
