# -*- coding: utf-8 -*-
"""PyTorch port: the running reference McSAS's runs, reconstructed by
the port's engine on the CPU in the K=1 reference-stepping mode at the
JAX package's tolerances (tests/test_reference_parity.py).

* The Sphere-run crossvals (test_crossval_histograms_match_reference,
  test_crossval_fit_curve_matches_reference,
  test_crossval_scaling_background) over the reference fixtures of the
  quickstart, sphere10 and gauss workloads.  The sphere10 run (200 × 20,
  ~4.7 M proposals) takes minutes on one CPU thread, so its cases are
  marked ``slow``.
* The joint cylinder run (testdata/reference_cyl_fixture.json: radius AND
  length active on the synthetic 2-population testdata/cylmix.dat), with
  the reference's own intDiv=100 quadrature in the loop (table_ff 'off').
  It steps ~170k times eagerly, minutes on the CPU, so it is marked
  ``slow``; its stand-in on the card is ``chip_smoke.py`` phase 17 (K=128,
  local moves 0.5, the two-axis table through K2's table entry)."""
import json
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu_torch import data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.post.histogram import (HistogramSpec,  # noqa: E402
                                            histogram_all)
from mcsas_tpu_torch.tools import suite  # noqa: E402

_TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"
# the reference fixtures of the Sphere-run crossvals and their datasets
# (tests/test_reference_parity.py:218-232)
_FIXTURES = {
    "quickstart": ("reference_quickstart_fixture.json",
                   "quickstartdemo1.csv"),
    "sphere10": ("reference_sphere10_fixture.json",
                 "sasfit_sphere-10-1.dat"),
    "gauss": ("reference_gauss_fixture.json",
              "sasfit_gauss2-5-1.5-2-1.dat"),
}
_MODEL_NAMES = {"sphere": "Sphere", "gaussianchain": "GaussianChain"}
_SLOW = {"sphere10"}


def _crossval_engine_run(fix, refdata, dataset, **variant):
    """The port's engine on the fixture's own workload and data pipeline
    (tests/test_reference_parity.py:235-261), on the CPU."""
    dcfg = (data.DataConfig(n_bin=0)
            if fix["workload"].get("noRebin") else None)
    d = data.load(refdata / dataset, config=dcfg)
    lo, hi = fix["workload"]["activeRange_m"]
    np.testing.assert_allclose(d.q, np.asarray(fix["fitX0"]), rtol=1e-9)
    model_name = _MODEL_NAMES[fix["workload"].get("model", "sphere")]
    bound = get_model(model_name).bind()
    np.testing.assert_allclose(bound.ranges[0], [lo, hi], rtol=1e-12)
    cfg = McSASConfig(num_contribs=int(fix["workload"]["numContribs"]),
                      num_reps=int(fix["workload"]["numReps"]),
                      max_iterations=8_000_000, chunk_steps=2000, seed=101,
                      max_retries=1, convergence_criterion=1.0, **variant)
    res = McSASEngine(d, bound, cfg, device="cpu").run()
    assert res.converged.all(), "engine must reach the reference's chi2<=1"
    return d, bound, cfg, res


@pytest.fixture(scope="module", params=[
    pytest.param(k, marks=[pytest.mark.slow] if k in _SLOW else [])
    for k in sorted(_FIXTURES)])
def crossval_run(request, refdata):
    """The port's engine in K=1 reference-stepping mode (sequential
    cursor, one proposal per iteration, accept if χ² improves) on the
    fixture's own workload: the two runs differ only in their random
    streams."""
    fixfile, dataset = _FIXTURES[request.param]
    fix = json.loads((_TESTDATA / fixfile).read_text())
    d, bound, cfg, res = _crossval_engine_run(
        fix, refdata, dataset, candidates_per_step=1)
    return fix, d, bound, cfg, res


@pytest.mark.parametrize("weight", ["vol", "num"])
def test_crossval_histograms_match_reference(crossval_run, weight):
    """Normalized bars within the reference's 0.2, the peak bin within
    one, and the weighted mean radius within the reference's rep-to-rep
    spread (3σ, a 5 % floor)."""
    fix, d, bound, cfg, res = crossval_run
    h_ref = fix["histograms"][weight]
    edges_ref, y_ref = np.asarray(h_ref["xLowerEdge"]), np.asarray(
        h_ref["yMean"])
    lo, hi = fix["workload"]["activeRange_m"]
    spec = HistogramSpec(bound.active[0], lo, hi, bin_count=len(y_ref),
                         xscale="log", yweight=weight,
                         auto_follow=False).resolved(bound)
    _, hists = histogram_all(res.contribs, d, bound, cfg, [spec],
                             device="cpu")
    h = hists[0]
    np.testing.assert_allclose(h.x_lower_edge, edges_ref, rtol=1e-9)
    y_eng = h.bins.mean / max(h.bins.mean.sum(), 1e-300)
    y_ref_n = y_ref / max(y_ref.sum(), 1e-300)
    np.testing.assert_allclose(y_eng, y_ref_n, atol=0.2)
    assert abs(int(np.argmax(y_eng)) - int(np.argmax(y_ref_n))) <= 1
    mean_eng = h.moments.mean[0]
    mean_ref, std_ref = (h_ref["moments"]["mean"][0],
                         h_ref["moments"]["mean"][1])
    tol = max(3.0 * abs(std_ref), 0.05 * abs(mean_ref))
    assert abs(mean_eng - mean_ref) <= tol, (
        f"{weight}-weighted mean radius {mean_eng} vs reference "
        f"{mean_ref} ± {std_ref}")


def test_crossval_fit_curve_matches_reference(crossval_run):
    """The rep-mean fit curve within 3σ of the data's uncertainty
    pointwise and within 1σ² on average."""
    fix, d, bound, cfg, res = crossval_run
    ref_mean = np.asarray(fix["fitMeasValMean"])
    eng_mean = np.asarray(res.measval, np.float64).mean(axis=0)
    fu = np.asarray(d.fu, np.float64)
    z = np.abs(eng_mean - ref_mean) / np.where(fu == 0, 1.0, fu)
    assert float(z.max()) < 3.0, (
        f"fit curve deviates {z.max():.2f}σ of data uncertainty")
    assert float((z ** 2).mean()) < 1.0, (
        f"fit curves differ by χ²-like {np.mean(z ** 2):.3f} per point")


def test_crossval_scaling_background(crossval_run):
    """Scaling and background means within 3× the combined rep-to-rep
    spread (scaling: a 2 % floor)."""
    fix, d, bound, cfg, res = crossval_run
    sc_ref, sc_std = fix["scaling_mean_std"]
    bg_ref, bg_std = fix["background_mean_std"]
    sc = np.asarray(res.scaling, np.float64)
    bg = np.asarray(res.background, np.float64)
    sc_tol = max(3.0 * math.hypot(sc_std, sc.std()), 0.02 * abs(sc_ref))
    assert abs(sc.mean() - sc_ref) <= sc_tol, (
        f"scaling {sc.mean():.4g} vs reference {sc_ref:.4g} ± {sc_std:.2g}")
    bg_tol = 3.0 * math.hypot(bg_std, bg.std())
    assert abs(bg.mean() - bg_ref) <= bg_tol, (
        f"background {bg.mean():.4g} vs reference {bg_ref:.4g} "
        f"± {bg_std:.2g}")


@pytest.mark.slow
def test_crossval_cylinder_joint_reconstruction():
    """Both histogrammed dimensions and both weightings against the
    reference's bars (within 0.2) and first moments (within the combined
    rep-to-rep spread), the fit curve within 3σ: the reference's own
    tolerances, as the JAX package holds its engine to them."""
    fix, d, bound, cfg = suite.cylinder_crossval_workload(
        candidates_per_step=1, table_ff="off")
    eng = McSASEngine(d, bound, cfg, device="cpu")
    assert not eng.uses_table and not eng.runs_cuda_kernel
    res = eng.run()
    suite.check_smearmc(fix, d, bound, cfg, res,
                        params=("radius", "length"))
