# -*- coding: utf-8 -*-
"""PyTorch port: the float64 post pass and fractions, held against the
JAX package on identical contributions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu import data as jax_data  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402
from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu.post import histogram as jax_hist  # noqa: E402
from mcsas_tpu_torch import data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.post import histogram  # noqa: E402

RTOL = 1e-10   # float64 on both sides; only summation order differs


@pytest.fixture(scope="module")
def post_inputs(refdata):
    path = refdata / "sasfit_sphere-10-1.dat"
    rs = np.random.default_rng(21)
    contribs = rs.uniform(2e-9, 4e-8, (3, 50, 1))
    kw = dict(num_contribs=50, num_reps=3)
    return dict(
        contribs=contribs,
        ours=(get_model("Sphere").bind(), data.load(path),
              McSASConfig(**kw)),
        ref=(jax_get_model("Sphere").bind(), jax_data.load(path),
             JaxConfig(**kw)))


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = np.maximum(np.abs(b), 1e-300)
    finite = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), finite)
    assert np.all(np.abs(a - b)[finite] <= RTOL * scale[finite])


def test_post_pass_matches_jax(post_inputs):
    ours = histogram._post_pass_f64(*post_inputs["ours"],
                                    post_inputs["contribs"])
    ref = jax_hist._post_pass_f64(*post_inputs["ref"],
                                  post_inputs["contribs"])
    names = ("wset", "vset", "sset", "scale", "background", "measval",
             "agofs", "minq")
    for name, a, b in zip(names, ours, ref):
        _close(a, np.broadcast_to(b, np.shape(a)))
        assert np.shape(a) == np.shape(b), name


def test_fractions_match_jax(post_inputs):
    c = post_inputs["contribs"]
    b, d, cfg = post_inputs["ours"]
    jb, jd, jcfg = post_inputs["ref"]
    ours = histogram.compute_fractions(c, d, b, cfg)
    ref = jax_hist.compute_fractions(c, jd, jb, jcfg)
    for w in histogram.WEIGHTINGS:
        _close(ours.fraction[w], ref.fraction[w])
        _close(ours.min_req[w], ref.min_req[w])
        _close(ours.total[w], ref.total[w])
    for name in ("scaling", "volumes", "surfaces", "agofs", "measval"):
        _close(getattr(ours, name), getattr(ref, name))


def test_histograms_match_jax(post_inputs):
    c = post_inputs["contribs"]
    b, d, cfg = post_inputs["ours"]
    jb, jd, jcfg = post_inputs["ref"]
    specs = [histogram.HistogramSpec("radius", 1e-9, 5e-8, bin_count=12,
                                     xscale="log", yweight=w)
             for w in ("vol", "num")]
    jspecs = [jax_hist.HistogramSpec("radius", 1e-9, 5e-8, bin_count=12,
                                     xscale="log", yweight=w)
              for w in ("vol", "num")]
    _, ours = histogram.histogram_all(c, d, b, cfg, specs)
    _, ref = jax_hist.histogram_all(c, jd, jb, jcfg, jspecs)
    for h, jh in zip(ours, ref):
        np.testing.assert_array_equal(h.x_lower_edge, jh.x_lower_edge)
        _close(h.bins.full, jh.bins.full)
        _close(h.cdf.full, jh.cdf.full)
        _close(h.observability, jh.observability)
        # moments come as (value, std over reps) pairs: a std of values
        # that agree to rounding is rounding noise, so each std is held
        # to RTOL of its value
        a, b = np.asarray(h.moments.fields), np.asarray(jh.moments.fields)
        scale = np.maximum(np.repeat(np.abs(b[0::2]), 2), np.abs(b))
        assert np.all(np.abs(a - b) <= RTOL * scale)
