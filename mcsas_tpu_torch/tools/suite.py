# -*- coding: utf-8 -*-
"""The suite rows of ``bench.py --suite`` (bench.py:155-222) whose chunks
run in K1, as the port fits them: data file, model, active set and
ranges, K, proposal budget and local moves; 300 contributions × 10
repetitions, chunks of 1024 steps, seed 2026, one retry, χ² ≤ 1.
``chip_smoke.py`` fits them on the card and ``tools/kern_probe.py``
probes K1 on their data.  The table-tier row 'cylinders-isotropic'
(bench.py:162-164), whose segments run in K2, stands beside them as
:func:`cylinder_golden`, :func:`cylinder_bound` and
:func:`cylinder_config`: its data is synthetic and made here.  The row
'cylinders-smeared' (bench.py:169-171) is the same binding and config on
:func:`cylinder_smeared_golden`, the slit-smeared golden: its table holds
smeared intensities and its segments run in K2 with the intensity row.
:data:`TABLE_ROWS` are the other table-tier rows, whose segments run in
K2's table entry: 'ellipsoids-isotropic' and 'core-shell-ellipsoid' on
synthetic goldens made here (:func:`ellipsoid_golden`,
:func:`core_shell_ellipsoid_golden`) and 'kholodenko-worm', whose lookup
multiplies the blend by the worm's cross-section (bench.py:155-222).
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..api import _default_unbounded_ranges
from ..config import McSASConfig
from ..data import (DataConfig, SASData, TrapezoidSmearing, from_raw,
                    load)
from ..models import get_model
from ..models.base import BoundModel
from ..models.cylinders import _cyl_iso_ff_ab, _cyl_iso_table_factory
from ..models.ellipsoids import _ell_cs_ff, _ell_iso_ff_uv
from ..ops import tables
from ..post.histogram import HistogramSpec, histogram_all
from ..utils.units import ANGSTROM_SLD

_TESTDATA = pathlib.Path(__file__).resolve().parents[2] / "testdata"


@dataclass(frozen=True)
class SuiteRow:
    name: str
    data: str                  # path under testdata/
    model: str
    active: Optional[tuple]    # None: the model's default active set
    ranges: Optional[dict]     # SI active-range overrides
    k_cand: int
    budget: int                # max_iterations
    local_moves: float
    # the parameters that generated the data, SI as the data load (q in
    # nm⁻¹): what the vol-weighted means of a converged fit come near
    truth: dict
    # SI values of parameters the row fixes (bench.py:213-214)
    fixed: Optional[dict] = None

    def load(self) -> SASData:
        """The row's data: a file under testdata/, or 'synth:<kind>', a
        synthetic golden made here."""
        if self.data.startswith("synth:"):
            return _GOLDENS[self.data[len("synth:"):]]()
        return load(_TESTDATA / self.data)

    def bound(self, data: SASData, active=None) -> BoundModel:
        """The row's binding, or the model's with *active* instead (the
        row's ranges kept where they apply); an unbounded active range
        becomes the data's size estimate, as ``fit()`` makes it."""
        active = self.active if active is None else active
        ranges = {k: v for k, v in (self.ranges or {}).items()
                  if active is None or k in active}
        bound = get_model(self.model).bind(active=active,
                                           active_ranges=ranges or None,
                                           fixed=self.fixed)
        return _default_unbounded_ranges(bound, data)

    def config(self, **kw) -> McSASConfig:
        base = dict(num_contribs=300, num_reps=10,
                    max_iterations=self.budget, chunk_steps=1024,
                    candidates_per_step=self.k_cand, seed=2026,
                    max_retries=1, convergence_criterion=1.0,
                    local_moves=self.local_moves, show_incomplete=True)
        base.update(kw)
        return McSASConfig(**base)


ROWS = {row.name: row for row in (
    SuiteRow("gaussian-chain", "sasfit_gauss2-5-1.5-2-1.dat",
             "GaussianChain", None, None, 64, 4_000_000, 0.0,
             {"rg": 5e-9}),
    SuiteRow("core-shell-sphere",
             "models/SphCoreShell_R100_dR150_c3p16_s2p53.csv",
             "SphericalCoreShell", ("radius", "t"), None, 128, 40_000_000,
             0.5, {"radius": 100e-9, "t": 150e-9}),
    SuiteRow("lma-dense-sphere", "sasfit_sphere-10-1.dat",
             "LMADenseSphere", ("radius", "volFrac"),
             {"volFrac": (1e-4, 0.1)}, 128, 20_000_000, 0.5,
             {"radius": 10e-9}),
)}


_NM = 1e-9     # bench.py's nm: its products round as bench.py's do
TABLE_ROWS = {row.name: row for row in (
    SuiteRow("ellipsoids-isotropic", "synth:ellipsoid",
             "EllipsoidsIsotropic", ("a",), {"a": (0.5 * _NM, 300 * _NM)},
             128, 8_000_000, 0.0, {"a": 10e-9}, fixed={"aspect": 3.0}),
    SuiteRow("core-shell-ellipsoid", "synth:ellcoreshell",
             "EllipsoidalCoreShell", ("a", "t"),
             {"a": (2 * _NM, 50 * _NM), "t": (10 * _NM, 200 * _NM)}, 128,
             40_000_000, 0.5, {"a": 10e-9, "t": 50e-9},
             fixed={"b": 15 * _NM}),
    SuiteRow("kholodenko-worm", "sasfit_kho-1-10-1000.dat", "Kholodenko",
             None, None, 128, 24_000_000, 0.75,
             {"radius": 1e-9, "lenKuhn": 10e-9, "lenContour": 1000e-9}),
)}


GOLDEN_RADIUS = 10e-9     # the synthetic cylinder's radius (aspect 10)


def cylinder_golden() -> SASData:
    """bench.synth_golden("cylinder") built with the port's float64
    functions: q = geomspace(0.01, 2, 100) nm⁻¹, I = ff² of the converged
    n=801 orientation rule at R = 10 nm, aspect 10, normalized to max 1,
    σ = 0.01·I, no rebinning."""
    q_nm = np.geomspace(0.01, 2.0, 100)
    q = torch.as_tensor(q_nm * 1e9, dtype=torch.float64)
    r, asp = GOLDEN_RADIUS, 10.0
    ff = _cyl_iso_ff_ab(q * r, q * (2.0 * r * asp), 801,
                        torch.float64).numpy()
    i = ff ** 2
    i = i / i.max()
    return from_raw(np.column_stack([q_nm, i, 0.01 * i]),
                    title="synthetic-cylinder", config=DataConfig(n_bin=0))


def cylinder_smeared_golden() -> SASData:
    """bench.synth_golden("cylinder-smeared") built with the port's
    float64 functions: the same q grid and cylinder, its converged-rule
    intensity pushed through the trapezoid slit contraction the fit will
    use (25 steps, umbra 0.05e9, penumbra 0.2e9 m⁻¹; reference smearing:
    sasmodel.py:56-73), normalized to max 1, σ = 0.01·I, no rebinning."""
    q_nm = np.geomspace(0.01, 2.0, 100)
    dcfg = DataConfig(n_bin=0, smearing=TrapezoidSmearing(
        do_smear=True, n_steps=25, umbra=0.05e9, penumbra=0.2e9))
    ones = np.ones_like(q_nm)
    d0 = from_raw(np.column_stack([q_nm, ones, 0.01 * ones]), config=dcfg)
    if not d0.uses_smearing:
        raise RuntimeError("the slit configuration did not engage smearing")
    locs = torch.as_tensor(np.asarray(d0.locs, np.float64))
    r, asp = GOLDEN_RADIUS, 10.0
    ff = _cyl_iso_ff_ab(locs * r, locs * (2.0 * r * asp), 801, torch.float64)
    i = ((ff * ff) @ torch.as_tensor(
        np.asarray(d0.smear_w, np.float64))).numpy()
    i = i / i.max()
    return from_raw(np.column_stack([q_nm, i, 0.01 * i]),
                    title="synthetic-cylinder-smeared", config=dcfg)


def _synthetic(q_nm, ff, kind) -> SASData:
    """I = ff² normalized to max 1, σ = 0.01·I, no rebinning: the form of
    bench.synth_golden."""
    i = np.asarray(ff, np.float64) ** 2
    i = i / i.max()
    return from_raw(np.column_stack([q_nm, i, 0.01 * i]),
                    title=f"synthetic-{kind}", config=DataConfig(n_bin=0))


def ellipsoid_golden() -> SASData:
    """bench.synth_golden("ellipsoid") built with the port's float64
    functions: q = geomspace(0.01, 2, 100) nm⁻¹, the converged n=801
    orientation rule of a spheroid with a = 10 nm, c = 30 nm."""
    q_nm = np.geomspace(0.01, 2.0, 100)
    q = torch.as_tensor(q_nm * 1e9, dtype=torch.float64)
    ff = _ell_iso_ff_uv(q * 10e-9, q * 30e-9, 801, torch.float64)
    return _synthetic(q_nm, ff.numpy(), "ellipsoid")


def core_shell_ellipsoid_golden() -> SASData:
    """bench.synth_golden("ellcoreshell") built with the port's float64
    functions: q = geomspace(0.01, 0.3, 100) nm⁻¹, a = 10, b = 15, t = 50
    nm, the default SLDs (core 3.15e-6, shell 2.53e-6 Å⁻², solvent 0),
    intDiv 801."""
    q_nm = np.geomspace(0.01, 0.3, 100)
    p = dict(a=10e-9, b=15e-9, t=50e-9,
             eta_c=ANGSTROM_SLD.to_si(3.15e-6),
             eta_s=ANGSTROM_SLD.to_si(2.53e-6), eta_sol=0.0, intDiv=801.0)
    ff = _ell_cs_ff(torch.as_tensor(q_nm * 1e9, dtype=torch.float64), p)
    return _synthetic(q_nm, ff.numpy(), "ellcoreshell")


_GOLDENS = {"ellipsoid": ellipsoid_golden,
            "ellcoreshell": core_shell_ellipsoid_golden}


def cylinder_bound() -> BoundModel:
    return get_model("CylindersIsotropic").bind(
        active=("radius",), active_ranges={"radius": (0.5e-9, 300e-9)})


def _opaque_factory(bound, q_grid, dtype, device):
    """The cylinder's own table behind a lookup that does not name its
    parameters: the same rows, but K2's table entry cannot know that the
    lookup only blends."""
    lookup, table = _cyl_iso_table_factory(bound, q_grid, dtype, device)

    def opaque(tab, pdict):
        return lookup(tab, pdict)
    return opaque, table


def _three_axis_factory(bound, q_grid, dtype, device):
    """The cylinder's rows over three table axes (radius, aspect, length;
    256 × 4 × 4 nodes; the rows do not depend on the length while
    ``useAspect`` is set): one axis more than K2's table entry blends."""
    fixed = dict(bound.fixed)
    names = ("radius", "aspect", "length")
    grids = [tables.log_grid(*tables.param_product_range(bound, p), n)
             for p, n in zip(names, tables.cap_res((256, 4, 4)))]
    q32 = torch.tensor(np.asarray(q_grid, np.float64), dtype=dtype,
                       device=device)

    def row_fn(vals):                   # (B, 3) -> (B, Nq)
        r, asp = vals[:, 0:1], vals[:, 1:2]
        return _cyl_iso_ff_ab(q32 * r, q32 * (2.0 * r * asp), 801, dtype)

    key = ("three-axis-cylinder", tables.grid_fingerprint(q_grid),
           tuple(sorted(fixed.items())))
    tab = tables.build_param_table(row_fn, grids, dtype, block=256,
                                   cache_key=key, device=device)
    return tables.make_lookup(names), tab


_UNBLENDABLE = {"opaque-lookup": _opaque_factory,
                "three-axes": _three_axis_factory}


def unblendable_cylinder(kind: str, **bind) -> BoundModel:
    """The cylinder model bound on a table that K2's table entry cannot
    blend itself (*kind*: 'opaque-lookup' or 'three-axes'), so that its
    segments go through K2's rows-in entry: what a later model with such
    a table will need, held by the tests and ``chip_smoke.py``.  *bind*
    as for ``SASModel.bind``; default: the cylinder row's binding."""
    model = dataclasses.replace(get_model("CylindersIsotropic"),
                                ff_table_factory=_UNBLENDABLE[kind])
    if not bind:
        bind = dict(active=("radius",),
                    active_ranges={"radius": (0.5e-9, 300e-9)})
    return model.bind(**bind)


def cylinder_config(**kw) -> McSASConfig:
    """bench.py's suite rows 'cylinders-isotropic' and 'cylinders-smeared'
    (bench.py:162-171, 213-222); table_ff 'auto' resolves to on at this
    budget."""
    base = dict(num_contribs=300, num_reps=10, max_iterations=8_000_000,
                chunk_steps=1024, candidates_per_step=128, seed=2026,
                max_retries=1, convergence_criterion=1.0, local_moves=0.0,
                show_incomplete=True)
    base.update(kw)
    return McSASConfig(**base)


# ------------------------------ the reference's slit-smeared MC workload

def smearmc_workload(**variant):
    """The running reference McSAS's own slit-smeared MC run
    (testdata/reference_smearmc_fixture.json: Sphere on the synthetic
    2-population testdata/smearmix.dat, trapezoid slit, no rebinning, 100
    contributions × 5 repetitions, χ² ≤ 1): ``(fixture, data, bound,
    config)``, the config with *variant* on top (K, local moves, chunk
    size, ...), as the JAX package's crossvals of that run bind it."""
    fix = json.loads((_TESTDATA / "reference_smearmc_fixture.json")
                     .read_text())
    wl = fix["workload"]
    umbra, penumbra = (float(v) for v in wl["smearing"].split(":"))
    data = load(_TESTDATA / "smearmix.dat", config=DataConfig(
        n_bin=0, smearing=TrapezoidSmearing(do_smear=True, umbra=umbra,
                                            penumbra=penumbra)))
    if (data.locs.shape[1] != wl["smearAudit"]["nIntPoints"]
            or not np.allclose(data.q, np.asarray(fix["fitX0"]), rtol=1e-9,
                               atol=0.0)):
        raise AssertionError("smearmix.dat does not load as the reference "
                             "ran it")
    ranges = {k: tuple(v) for k, v in wl["activeRanges_m"].items()}
    bound = get_model("Sphere").bind(active=("radius",),
                                     active_ranges=ranges)
    base = dict(num_contribs=int(wl["numContribs"]),
                num_reps=int(wl["numReps"]),
                convergence_criterion=wl["convergenceCriterion"],
                max_iterations=8_000_000, chunk_steps=4000, seed=101,
                max_retries=1)
    base.update(variant)
    return fix, data, bound, McSASConfig(**base)


# ------------------------ the reference's joint-cylinder MC workload

def cylinder_crossval_workload(**variant):
    """The running reference McSAS's joint cylinder run
    (testdata/reference_cyl_fixture.json: CylindersIsotropic with radius
    AND length active, useAspect off, on the synthetic 2-population
    testdata/cylmix.dat, 100 contributions × 5 repetitions, χ² ≤ 0.2):
    ``(fixture, data, bound, config)``, the config with *variant* on top,
    as the JAX package's crossvals of that run bind it
    (tests/test_reference_parity.py, ``_cyl_engine_run``)."""
    fix = json.loads((_TESTDATA / "reference_cyl_fixture.json")
                     .read_text())
    wl = fix["workload"]
    data = load(_TESTDATA / "cylmix.dat")
    if not np.allclose(data.q, np.asarray(fix["fitX0"]), rtol=1e-9,
                       atol=0.0):
        raise AssertionError("cylmix.dat does not load as the reference "
                             "ran it")
    ranges = {k: tuple(v) for k, v in wl["activeRanges_m"].items()}
    bound = get_model("CylindersIsotropic").bind(
        active=("radius", "length"), active_ranges=ranges,
        fixed={"useAspect": 0.0})
    base = dict(num_contribs=int(wl["numContribs"]),
                num_reps=int(wl["numReps"]),
                convergence_criterion=wl["convergenceCriterion"],
                max_iterations=8_000_000, chunk_steps=4000, seed=101,
                max_retries=1)
    base.update(variant)
    return fix, data, bound, McSASConfig(**base)


def check_smearmc(fix, data, bound, cfg, res, weights=("vol", "num"),
                  check_moments=True, device="cpu", params=None,
                  bar_limit=0.2) -> dict:
    """Holds an engine result *res* of :func:`smearmc_workload` (or, with
    *params*, of :func:`cylinder_crossval_workload`: the fixture's
    histograms keyed ``'<param>:<weight>'``) to the reference's run, by
    the reference's own tolerances (the JAX package's
    ``_cyl_check_distributions``): every repetition converged; per
    parameter and weighting the normalized histogram within 0.2 of the
    reference's bars (*bar_limit*; None: measured, not held) and, with
    *check_moments*, its mean within the
    combined rep-to-rep spread (3σ, or 10 %); the mean fitted curve
    within 3σ of the data uncertainty everywhere and below 1σ² on
    average.  Raises AssertionError; returns what it measured."""
    if not res.converged.all():
        raise AssertionError(f"{int(res.converged.sum())}/{res.num_reps} "
                             f"repetitions reached the reference's chi2 "
                             f"criterion (chi2 {res.conval})")
    out = {}
    for pname in params or ("radius",):
        lo, hi = fix["workload"]["activeRanges_m"][pname]
        for weight in weights:
            label = weight if params is None else f"{pname}:{weight}"
            h_ref = fix["histograms"][label]
            y_ref = np.asarray(h_ref["yMean"], np.float64)
            spec = HistogramSpec(pname, lo, hi, bin_count=len(y_ref),
                                 xscale="log", yweight=weight,
                                 auto_follow=False).resolved(bound)
            h = histogram_all(res.contribs, data, bound, cfg, [spec],
                              device=device)[1][0]
            if not np.allclose(h.x_lower_edge,
                               np.asarray(h_ref["xLowerEdge"]), rtol=1e-9,
                               atol=0.0):
                raise AssertionError(f"{label}: histogram edges differ")
            y_eng = h.bins.mean / max(h.bins.mean.sum(), 1e-300)
            bar = float(np.max(np.abs(y_eng - y_ref / max(y_ref.sum(),
                                                          1e-300))))
            out[f"bar_diff_{label.replace(':', '_')}"] = bar
            if bar_limit is not None and not bar <= bar_limit:
                raise AssertionError(f"{label}: normalized bars differ by "
                                     f"{bar:.3g} (limit {bar_limit})")
            if check_moments:
                mean_ref, std_ref = h_ref["moments"]["mean"]
                mean_eng, std_eng = h.moments.mean
                tol = max(3.0 * math.hypot(std_ref, std_eng),
                          0.10 * abs(mean_ref))
                if not abs(mean_eng - mean_ref) <= tol:
                    raise AssertionError(
                        f"{label}: mean {mean_eng:.3e} against the "
                        f"reference's {mean_ref:.3e} ± {std_ref:.2e}")
    fu = np.asarray(data.fu, np.float64)
    z = np.abs(np.asarray(res.measval, np.float64).mean(axis=0)
               - np.asarray(fix["fitMeasValMean"])) \
        / np.where(fu == 0, 1.0, fu)
    out["curve_max_sigma"] = float(z.max())
    out["curve_mean_sigma2"] = float((z ** 2).mean())
    if not (out["curve_max_sigma"] < 3.0 and out["curve_mean_sigma2"] < 1.0):
        raise AssertionError(f"fit curve deviates {z.max():.2f} sigma "
                             f"(mean square {out['curve_mean_sigma2']:.2f})")
    return out
