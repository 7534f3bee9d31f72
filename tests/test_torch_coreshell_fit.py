# -*- coding: utf-8 -*-
"""PyTorch port end to end on the CPU for a two-parameter elementwise
model: ``mcsas_tpu_torch.fit`` of SphericalCoreShell (core radius and
shell thickness active) at K=128 with local moves 0.5, held to the
running reference McSAS's core-shell fit (testdata/reference_cs_fixture
.json on csmix.dat) within the tolerances of the JAX package's own
crossval of that fixture (test_reference_parity.py,
test_crossval_coreshell_local_moves)."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mcsas_tpu_torch import HistogramSpec, fit, load  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402

_TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"


@pytest.fixture(scope="module")
def cs_fit():
    """The fixture's workload (100 contributions × 5 repetitions, χ² ≤
    1, both active boxes) with the accelerated sampler, K=128 and local
    moves 0.5, on the CPU (~15 s on 2 threads)."""
    fix = json.loads((_TESTDATA / "reference_cs_fixture.json").read_text())
    wl = fix["workload"]
    d = load(_TESTDATA / "csmix.dat")
    np.testing.assert_allclose(d.q, np.asarray(fix["fitX0"]), rtol=1e-9)
    ranges = {k: tuple(v) for k, v in wl["activeRanges_m"].items()}
    bound = get_model("SphericalCoreShell").bind(active=("radius", "t"),
                                                 active_ranges=ranges)
    cfg = McSASConfig(num_contribs=int(wl["numContribs"]),
                      num_reps=int(wl["numReps"]),
                      convergence_criterion=wl["convergenceCriterion"],
                      max_iterations=8_000_000, chunk_steps=500, seed=101,
                      max_retries=1, candidates_per_step=128,
                      local_moves=0.5)
    return fix, d, fit(d, bound, cfg, device="cpu")


def test_coreshell_fit_converges(cs_fit):
    _, d, res = cs_fit
    assert res.converged and res.engine.conval.max() <= 1.0
    assert not res.engine.used_pallas and not res.engine.used_table
    assert res.contribs.shape == (100, 2, 5)
    assert np.isfinite(res.fractions.measval).all()
    assert res.fractions.measval.shape == (5, d.count)


@pytest.mark.parametrize("param", ["radius", "t"])
def test_coreshell_distributions_match_reference(cs_fit, param):
    """Everything the data constrains: the vol-weighted distribution of
    each active parameter within 0.2 on normalized bars (the reference's
    own regression tolerance, mcsas_test.py:105-116) over the fixture's
    log bins."""
    fix, _, res = cs_fit
    lo, hi = fix["workload"]["activeRanges_m"][param]
    h_ref = fix["histograms"][f"{param}:vol"]
    y_ref = np.asarray(h_ref["yMean"], np.float64)
    spec = HistogramSpec(param, lo, hi, bin_count=len(y_ref), xscale="log",
                         yweight="vol", auto_follow=False)
    h = res.histogram([spec]).histograms[0]
    np.testing.assert_allclose(h.x_lower_edge,
                               np.asarray(h_ref["xLowerEdge"]), rtol=1e-9)
    y_eng = h.bins.mean / max(h.bins.mean.sum(), 1e-300)
    np.testing.assert_allclose(y_eng, y_ref / max(y_ref.sum(), 1e-300),
                               atol=0.2)


def test_coreshell_fit_curve_matches_reference(cs_fit):
    """The mean fitted curve within 3σ of the data uncertainty of the
    reference's mean curve everywhere, and within 1σ in the mean square."""
    fix, d, res = cs_fit
    fu = np.asarray(d.fu, np.float64)
    z = np.abs(np.asarray(res.engine.measval, np.float64).mean(axis=0)
               - np.asarray(fix["fitMeasValMean"])) \
        / np.where(fu == 0, 1.0, fu)
    assert float(z.max()) < 3.0
    assert float((z ** 2).mean()) < 1.0
