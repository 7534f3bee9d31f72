# -*- coding: utf-8 -*-
"""Headless user API: fit a dataset, inspect results, write output files::

    result = fit(data, model="Sphere", cfg=McSASConfig(...), device="cuda")

Replaces the reference's GUI-driven Calculator orchestration
(src/mcsas/gui/calc.py:219-331) with a pure function, plus
:func:`run_files` for the per-file pipeline including the reference's
output-file set (settings .cfg, fit/distribution/statistics .dat files,
contributions pickle, HDF5 state archive and optional plot; reference
writers: gui/calc.py:381-462, output set documented in
doc/source/quickstart.rst:164-177).  The compute device is explicit:
``device="cuda"`` (the default) raises when there is no card.
"""
from __future__ import annotations

import configparser
import logging
import math
import os
import pickle
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from . import data as data_mod
from .config import McSASConfig
from .core.engine import EngineResult, McSASEngine, resolve_device
from .data import SASData
from .io.ascii import format_value, write_ascii
from .models import get_model
from .models.base import BoundModel, SASModel
from .parallel import ShardedEnsemble
from .post.histogram import (FractionsResult, HistogramSpec, Moments,
                             histogram_all)
from .utils.log import RunLogFile, timestamp_formatted

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


# engines built for one (data content, model, config, device) — reused
# across fit() calls so a series of same-content files pays the engine's
# set-up once.  An engine restarts its generator from cfg.seed on every
# run, so a reused engine gives the result a fresh one would.
_ENGINE_CACHE: dict = {}
_ENGINE_CACHE_CAP = 8


def _fit_device(device, mesh) -> torch.device:
    """Where a fit runs: *device* ("cuda" when None) or, with a *mesh*,
    the mesh's first device; a *device* that disagrees with the mesh
    raises."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    first = resolve_device(mesh.devices[0])
    if device is not None:
        want = torch.device(device)
        if want.type != first.type or (want.index is not None
                                       and want != first):
            raise ValueError(f"device={str(device)!r} disagrees with the "
                             f"mesh, whose first device is {first}")
    return first


def _cached_engine(engine_cls, data: SASData, bound: BoundModel,
                   cfg: McSASConfig, device, mesh=None):
    """The engine of (data content, model, config, device, mesh) from the
    cache, built on a miss: a :class:`ShardedEnsemble` over *mesh* where
    one is given, else an *engine_cls* on *device*."""
    device = _fit_device(device, mesh)

    def build():
        if mesh is not None:
            return ShardedEnsemble(data, bound, cfg, mesh=mesh)
        return engine_cls(data, bound, cfg, device=device)
    try:
        # construction-environment inputs that shape the engine (a table
        # baked under MCSAS_TPU_TABLE_RES_CAP, or with the interpolation
        # probe switched by MCSAS_TPU_TABLE_PROBE) must not be silently
        # reused after the environment changes
        env = tuple(os.environ.get(k, "") for k in
                    ("MCSAS_TPU_TABLE_RES_CAP", "MCSAS_TPU_TABLE_PROBE"))
        key = (engine_cls, data.content_key(), bound, cfg, device, mesh,
               env)
        hash(key)    # a custom model piece may not be hashable
    except TypeError:
        return build()
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        eng = build()
        if len(_ENGINE_CACHE) >= _ENGINE_CACHE_CAP:
            _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
        _ENGINE_CACHE[key] = eng
    return eng


def fit(data: Union[SASData, str, os.PathLike],
        model=None,
        cfg: Optional[McSASConfig] = None,
        histograms: Optional[Sequence[HistogramSpec]] = None,
        stop: Optional[Callable[[], bool]] = None,
        progress: Optional[Callable[[dict], None]] = None,
        device=None, mesh=None) -> McSASResult:
    """Runs the full MC analysis on one dataset.

    - *data*: a SASData or a path to a data file
    - *model*: model name, SASModel, or BoundModel (default Sphere)
    - *cfg*: algorithm settings (defaults mirror the reference JSON)
    - *histograms*: histogram specs (default: one per active parameter)
    - *stop*: callable polled between chunks for cooperative abort
      (reference stop flag: mcsas.py:240-245,357)
    - *progress*: callable receiving per-rep χ² and counters per chunk
    - *device*: where the MC loop and the float64 post pass run; "cuda"
      (the default without a mesh) raises when torch.cuda.is_available()
      is False
    - *mesh*: a ``parallel.Mesh`` to shard the ensemble over (a
      :class:`ShardedEnsemble`; the post pass runs on its first device);
      a *device* that disagrees with it raises

    The engine comes from :func:`_cached_engine`: a repeat fit of the
    same (data content, model, config, device, mesh) skips the engine's
    set-up (magnitude probe, table bake and probe) and gives the same
    result.
    """
    if not isinstance(data, SASData):
        data = data_mod.load(data)
    bound = _resolve_model(model)
    bound = _default_unbounded_ranges(bound, data)
    cfg = cfg or McSASConfig()
    engine = _cached_engine(McSASEngine, data, bound, cfg, device, mesh)
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


# ------------------------------------------------------------------ output

class OutputFiles:
    """Result-file naming and writing (reference OutputFilename +
    Calculator writers: gui/calc.py:58-155, 381-462)."""

    def __init__(self, result: McSASResult, out_dir=None, basename=None,
                 create_dir: bool = True):
        self.result = result
        title = result.data.title or "mcsas"
        self.basename = basename or f"{title} {timestamp_formatted()}"
        base = out_dir
        if base is None:
            base = (os.path.dirname(result.data.filename)
                    if result.data.filename else ".")
        target = os.path.join(str(base), self.basename)
        if create_dir:
            os.makedirs(target, exist_ok=True)
            self.out_dir = target
        else:
            self.out_dir = str(base)

    def path(self, kind: str, extension: str = ".dat") -> str:
        return os.path.join(self.out_dir,
                            f"{self.basename}_{kind}{extension}")

    # --- individual writers --------------------------------------------
    def write_fit(self) -> str:
        """q, data, σ, fit mean, fit std (reference _writeFit)."""
        r = self.result
        fn = self.path("fit")
        cols = np.column_stack([
            r.fit_x0, r.data.f, r.data.fu,
            r.fit_measval_mean, r.fit_measval_std])
        write_ascii(fn, cols, header=("fitX0", "dataMean", "dataStd",
                                      "fitMeasValMean", "fitMeasValStd"))
        return fn

    def write_distributions(self) -> list:
        """One file per histogram: xMean xWidth yMean yStd Obs cdfMean
        cdfStd (reference _writeDistrib)."""
        out = []
        for h in self.result.histograms:
            tag = (f"hist-{h.spec.param}-{h.spec.lower:g}-{h.spec.upper:g}"
                   f"-{h.spec.bin_count}-{h.spec.xscale}-{h.spec.yweight}")
            fn = self.path(tag)
            write_ascii(fn, histogram_columns(h), header=HIST_HEADER)
            out.append(fn)
        return out

    def write_statistics(self) -> list:
        """Per-parameter moments table (reference _writeStatistics)."""
        out = []
        by_param = {}
        for h in self.result.histograms:
            by_param.setdefault(h.spec.param, []).append(h)
        header = ("lower", "upper", "weighting") + Moments.FIELD_NAMES
        for param, hists in by_param.items():
            fn = self.path(f"stats_{param}")
            lines = [" ".join(header)]
            for h in hists:
                vals = ([format_value(h.spec.lower),
                         format_value(h.spec.upper), h.spec.yweight]
                        + [format_value(v) for v in h.moments.fields])
                lines.append(" ".join(str(v) for v in vals))
            with open(fn, "w", encoding="utf-8") as fd:
                fd.write("\n".join(lines) + "\n")
            out.append(fn)
        return out

    def write_contribs(self) -> str:
        """Pickled contributions in the reference (N, P, R) layout —
        reusable for re-histogramming without re-optimization
        (reference _writeContribs: gui/calc.py:419-426)."""
        fn = self.path("contributions", ".pickle")
        with open(fn, "wb") as fd:
            pickle.dump(self.result.contribs, fd)
        return fn

    def write_settings(self) -> str:
        """ini-style settings dump (reference _writeSettings)."""
        r = self.result
        config = configparser.RawConfigParser()
        config.add_section("I/O Settings")
        config.set("I/O Settings", "fileName", str(r.data.filename))
        config.set("I/O Settings", "outputBaseName", self.basename)
        config.add_section("MCSAS Settings")
        for key, value in r.cfg.to_dict().items():
            config.set("MCSAS Settings", key, value)
        config.set("MCSAS Settings", "model", r.bound.model.name)
        config.set("MCSAS Settings", "X0 limits", str(list(r.data.q_limit)))
        config.add_section("Model Settings")
        for name, (lo, hi) in zip(r.bound.active, r.bound.ranges):
            config.set("Model Settings", f"{name}_min", lo)
            config.set("Model Settings", f"{name}_max", hi)
        for name, value in r.bound.fixed:
            config.set("Model Settings", name, value)
        fn = self.path("settings", ".cfg")
        with open(fn, "w", encoding="utf-8") as fd:
            config.write(fd)
        return fn

    def write_archive(self) -> Optional[str]:
        """HDF5 state archive (reference hdfStore: gui/calc.py:302-309);
        raises ImportError without h5py."""
        from .io.hdf import write_archive
        fn = self.path("hdf5archive", ".hdf5")
        return write_archive(fn, self.result)

    def write_all(self, plot: bool = False) -> dict:
        written = dict(
            settings=self.write_settings(),
            fit=self.write_fit(),
            distributions=self.write_distributions(),
            statistics=self.write_statistics(),
            contributions=self.write_contribs(),
        )
        try:
            written["archive"] = self.write_archive()
        except ImportError:
            log.warning("h5py unavailable; skipping HDF5 archive")
        if plot:
            from .plotting import plot_results
            fn = self.path("plot", ".pdf")
            plot_results(self.result, output_filename=fn,
                         auto_close=True)
            written["plot"] = fn
        return written


HIST_HEADER = ("xMean", "xWidth", "yMean", "yStd", "Obs", "cdfMean",
               "cdfStd")


def histogram_columns(h) -> np.ndarray:
    """The columns of a distribution file, in :data:`HIST_HEADER` order."""
    return np.column_stack([h.x_mean, h.x_width, h.bins.mean, h.bins.std,
                            h.observability, h.cdf.mean, h.cdf.std])


def run_files(filenames: Sequence, model=None,
              cfg: Optional[McSASConfig] = None, histograms=None,
              out_dir=None, plot: bool = False, data_config=None,
              device=None, mesh=None) -> list:
    """Runs a series of data files: fits each on *device* (or over
    *mesh*, as :func:`fit` takes them) and writes the full output-file
    set; accumulates series statistics when cfg.series_stats (reference
    Calculator.__call__ per-file pipeline + series handling:
    gui/calc.py:276-379).  Files of the same content, model and config
    share one cached engine (:func:`_cached_engine`)."""
    cfg = cfg or McSASConfig()
    results = []
    series = {}
    for fn in filenames:
        d = data_mod.load(fn, config=data_config)
        # pre-create the output dir so the per-run log file (reference:
        # gui/calc.py:283-288) captures the whole fit
        probe = McSASResult(data=d, bound=_resolve_model(model), cfg=cfg,
                            engine=None, fractions=None, histograms=[])
        out = OutputFiles(probe, out_dir=out_dir)
        with RunLogFile(out.path("log", ".txt")):
            res = fit(d, model=model, cfg=cfg, histograms=histograms,
                      device=device, mesh=mesh)
            out.result = res
            res.output_files = out.write_all(plot=plot)
        results.append(res)
        if cfg.series_stats:
            for h in res.histograms:
                key = (h.spec.param, h.spec.lower, h.spec.upper,
                       h.spec.yweight)
                series.setdefault(key, []).append(
                    (d.title, h.moments.fields))
    if cfg.series_stats and series:
        fn = write_series_stats(series, out_dir or ".")
        if plot:
            from .plotting import plot_series_stats
            plot_series_stats(series, output_filename=str(fn).replace(
                ".dat", ".pdf"))
    return results


def write_series_stats(series: dict, out_dir) -> str:
    """Cross-file moments table (reference processSeries/postProcess:
    gui/calc.py:161-217, 333-379)."""
    fn = os.path.join(str(out_dir),
                      f"series statistics {timestamp_formatted()}.dat")
    lines = []
    header = ("param", "lower", "upper", "weighting", "sample") + \
        Moments.FIELD_NAMES
    lines.append(" ".join(header))
    for (param, lo, hi, weight), entries in series.items():
        for title, fields in entries:
            row = [param, f"{lo:g}", f"{hi:g}", weight,
                   str(title).replace(" ", "_")]
            row += [f"{v: 14.6E}" for v in fields]
            lines.append(" ".join(row))
    with open(fn, "w", encoding="utf-8") as fd:
        fd.write("\n".join(lines) + "\n")
    return fn
