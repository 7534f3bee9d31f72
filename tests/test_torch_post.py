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


def _slit(mod):
    return mod.DataConfig(smearing=mod.TrapezoidSmearing(
        do_smear=True, n_steps=12, umbra=0.05e9, penumbra=0.2e9))


def _inputs(refdata, smear):
    """Random contributions on the sphere dataset, as both packages load
    it: as it is, or under a trapezoid slit of 13 offsets (the bank is
    then (ff²(locs) @ smear_w)·w)."""
    path = refdata / "sasfit_sphere-10-1.dat"
    rs = np.random.default_rng(21)
    contribs = rs.uniform(2e-9, 4e-8, (3, 50, 1))
    kw = dict(num_contribs=50, num_reps=3)
    ours = data.load(path, config=_slit(data) if smear else None)
    ref = jax_data.load(path, config=_slit(jax_data) if smear else None)
    assert ours.uses_smearing == ref.uses_smearing == smear
    return dict(
        contribs=contribs,
        ours=(get_model("Sphere").bind(), ours, McSASConfig(**kw)),
        ref=(jax_get_model("Sphere").bind(), ref, JaxConfig(**kw)))


@pytest.fixture(scope="module")
def post_inputs(refdata):
    return _inputs(refdata, smear=False)


@pytest.fixture(scope="module")
def smeared_post_inputs(refdata):
    return _inputs(refdata, smear=True)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = np.maximum(np.abs(b), 1e-300)
    finite = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), finite)
    assert np.all(np.abs(a - b)[finite] <= RTOL * scale[finite])


def _check_post_pass(post_inputs):
    ours = histogram._post_pass_f64(*post_inputs["ours"],
                                    post_inputs["contribs"])
    ref = jax_hist._post_pass_f64(*post_inputs["ref"],
                                  post_inputs["contribs"])
    names = ("wset", "vset", "sset", "scale", "background", "measval",
             "agofs", "minq")
    for name, a, b in zip(names, ours, ref):
        _close(a, np.broadcast_to(b, np.shape(a)))
        assert np.shape(a) == np.shape(b), name


def _check_fractions(post_inputs):
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


def _check_histograms(post_inputs):
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


@pytest.mark.parametrize("model", ["Sphere", "CylindersIsotropic"])
def test_smeared_bank_in_blocks_equals_the_whole(refdata, model):
    """The smeared float64 bank is evaluated in blocks of contributions
    (a smeared cylinder's whole bank would take gigabytes per temporary):
    each contribution's row is its own, so any block size gives the same
    result bit for bit as the whole in one block; and the cylinder's
    smeared post pass agrees with the JAX package's at RTOL."""
    path = refdata / "sasfit_sphere-10-1.dat"
    d = data.load(path, config=_slit(data))
    bind = {} if model == "Sphere" else dict(
        active=("radius",), active_ranges={"radius": (1e-9, 5e-8)},
        fixed={"intDiv": 20.0})
    bound = get_model(model).bind(**bind)
    cfg = McSASConfig(num_contribs=7, num_reps=2)
    contribs = np.random.default_rng(5).uniform(2e-9, 4e-8, (2, 7, 1))
    whole = histogram._post_pass_f64(bound, d, cfg, contribs,
                                     bank_block=14)
    for block in (1, 3, None):
        part = histogram._post_pass_f64(bound, d, cfg, contribs,
                                        bank_block=block)
        for a, b in zip(part, whole):
            np.testing.assert_array_equal(a, b)
    ref = jax_hist._post_pass_f64(
        jax_get_model(model).bind(**bind),
        jax_data.load(path, config=_slit(jax_data)),
        JaxConfig(num_contribs=7, num_reps=2), contribs)
    for a, b in zip(whole, ref):
        _close(a, np.broadcast_to(b, np.shape(a)))


def test_2d_post_pass_still_raises(refdata):
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    model = get_model("Sphere")
    import dataclasses
    two_d = dataclasses.replace(d, psi=np.zeros_like(d.q))
    bound = dataclasses.replace(model, ff2d=lambda q, psi, p: q).bind()
    with pytest.raises(NotImplementedError, match="2D"):
        histogram._post_pass_f64(bound, two_d, McSASConfig(),
                                 np.full((1, 2, 1), 1e-8))


def test_post_pass_matches_jax(post_inputs):
    _check_post_pass(post_inputs)


def test_fractions_match_jax(post_inputs):
    _check_fractions(post_inputs)


def test_histograms_match_jax(post_inputs):
    _check_histograms(post_inputs)


def test_smeared_post_pass_matches_jax(smeared_post_inputs):
    """The smeared float64 pass, (ff²(locs) @ smear_w)·w on the offsets
    grid, against the JAX package's at RTOL."""
    _check_post_pass(smeared_post_inputs)


def test_smeared_fractions_match_jax(smeared_post_inputs):
    _check_fractions(smeared_post_inputs)


def test_smeared_histograms_match_jax(smeared_post_inputs):
    _check_histograms(smeared_post_inputs)
