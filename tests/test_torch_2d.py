# -*- coding: utf-8 -*-
"""PyTorch port, 2D (q, ψ) fitting: the engine's 2D rows (the model's
anisotropic ff2d on the fit grid's (q, ψ) pairs), its magnitude probe,
the 2D float64 post pass and fit() on the CPU — port versions of the JAX
package's tests/test_2d.py and comparisons with the JAX package on the
same image and contributions.  2D takes no table and no kernel: the plain
chunk (the scan-path comparison is in tests/test_torch_psi_cylinders.py)."""
import dataclasses
import logging
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcsas_tpu import data as jax_data  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402
from mcsas_tpu.core import engine as jax_engine  # noqa: E402
from mcsas_tpu.models import cylinders as jax_cyl  # noqa: E402
from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu.post import histogram as jax_hist  # noqa: E402
import mcsas_tpu_torch as mt  # noqa: E402
from mcsas_tpu_torch import data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import (McSASEngine,  # noqa: E402
                                         magnitude_probe)
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.models.cylinders import (  # noqa: E402
    _cyl_radial_ff2d, _cyl_tilted_ff2d)
from mcsas_tpu_torch.post import histogram  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402

NM = 1e-9
PSI0 = suite.PSI0
R_TRUE = 5 * NM
ASPECT = 10.0
BIND = dict(active=("radius", "psiAngle"),
            active_ranges={"radius": (1 * NM, 20 * NM)})


def synth_2d(n_q=24, n_psi=16):
    """tests/test_2d.py::synth_2d through the port: 2 % uncertainty."""
    return suite.cylinder_2d_golden(n_q, n_psi, rel_sigma=0.02)


def jax_synth_2d(n_q=24, n_psi=16):
    """The JAX package's own synth_2d (tests/test_2d.py), verbatim."""
    q_nm = np.geomspace(0.05, 1.5, n_q)
    psi = np.linspace(0.05, 2 * math.pi, n_psi, endpoint=False)
    qg, pg = np.meshgrid(q_nm * 1e9, psi, indexing="ij")
    p = {"radius": R_TRUE, "aspect": ASPECT, "psiAngle": PSI0}
    ff = np.asarray(jax.jit(lambda q, s: jax_cyl._cyl_radial_ff2d(
        q, s, p))(jnp.asarray(qg.ravel()), jnp.asarray(pg.ravel())))
    vol = math.pi * R_TRUE ** 2 * 2 * R_TRUE * ASPECT
    i = (ff * vol) ** 2
    i = i / i.max() + 1e-4
    raw = np.column_stack([qg.ravel() / 1e9, i, 0.02 * i,
                           np.degrees(pg.ravel())])
    return jax_data.from_raw(raw, title="synthetic-2d",
                             config=jax_data.DataConfig(n_bin=0,
                                                        fit_2d=True))


@pytest.fixture(scope="module")
def image():
    return synth_2d(), jax_synth_2d()


# ------------------------------------------- tests/test_2d.py, ported

def test_2d_data_grid(image):
    """The image keeps ψ on the fit grid, as the JAX package loads it:
    q, I, σ and ψ to 1e-12 relative."""
    d, jd = image
    assert d.is2d
    assert d.psi is not None and d.psi.shape == d.q.shape
    assert d.count == 24 * 16
    for k in ("q", "f", "fu", "psi"):
        np.testing.assert_allclose(getattr(d, k), getattr(jd, k),
                                   rtol=1e-12)


def test_2d_ff_consistency():
    """The 1D radial kernel is the ψ-average of the 2D kernel."""
    q = torch.as_tensor(np.geomspace(1e7, 1e9, 32))
    p = {"radius": R_TRUE, "aspect": ASPECT, "psiAngle": 0.3,
         "psiAngleDivisions": 1801.0}
    ff1d = get_model("CylindersRadiallyIsotropic").ff(q, p).numpy()
    psi = torch.as_tensor(np.linspace(0.0, 2 * math.pi, 3600,
                                      endpoint=False))
    ff2 = _cyl_radial_ff2d(q[:, None], psi[None, :], p).numpy()
    avg = np.sqrt(np.mean(ff2 ** 2, axis=1))
    np.testing.assert_allclose(avg, ff1d, rtol=2e-2)


def test_2d_tilted_ff_consistency():
    """The tilted cylinder's 1D ff is (up to the tiny upstream tilt
    spread) the ψ-RMS of its 2D kernel on the same degree grid, to 1e-2."""
    q = torch.as_tensor(np.geomspace(1e7, 1e9, 32))
    p = {"radius": 4e-9, "aspect": 7.0, "psiAngle": 0.1,
         "psiAngleDivisions": 303.0, "phiDistWidth": 10.0,
         "phiDistDivisions": 9.0}
    ff1d = get_model("CylindersRadiallyIsotropicTilted").ff(q, p).numpy()
    psi_deg = np.linspace(0.1, 180.1, 303)
    # the 1D grid ignores psiAngle; feed azimuths that cancel the 2D
    # kernel's psiAngle rotation
    psi = torch.as_tensor(np.radians(psi_deg + p["psiAngle"]))
    f2 = _cyl_tilted_ff2d(q[:, None], psi[None, :], p).numpy()
    rms = np.sqrt(np.mean(f2 ** 2, axis=1))
    np.testing.assert_allclose(rms, ff1d, rtol=1e-2)


def test_2d_tilted_fit_runs():
    """The tilted model fits 2D images (its ff2d keeps the tilt
    average)."""
    d = synth_2d(n_q=12, n_psi=8)
    bound = get_model("CylindersRadiallyIsotropicTilted").bind(
        active=("radius",), active_ranges={"radius": (1.0, 20.0)})
    cfg = McSASConfig(num_contribs=8, num_reps=1, max_iterations=600,
                      chunk_steps=200, candidates_per_step=2, seed=2,
                      max_retries=0, show_incomplete=True)
    res = mt.fit(d, model=bound, cfg=cfg, device="cpu")
    assert np.all(np.isfinite(res.engine.conval))
    assert not res.engine.used_table


def test_2d_anisotropic_fit_descends(image):
    """Fitting (radius, psiAngle) against the anisotropic image: χ²
    descends and the fitted orientation clusters near the truth (the
    volume-weighted circular mean of psiAngle within 0.3 rad of ψ₀ mod
    π)."""
    d, _ = image
    bound = get_model("CylindersRadiallyIsotropic").bind(**BIND)
    cfg = McSASConfig(num_contribs=20, num_reps=2, max_iterations=6000,
                      chunk_steps=500, candidates_per_step=4, seed=9,
                      max_retries=0, show_incomplete=True)
    eng = McSASEngine(d, bound, cfg, device="cpu")
    eng.gen.manual_seed(1)
    chi0 = eng._init_batch().conval.numpy()
    res = eng.run()
    assert np.all(np.isfinite(res.conval))
    assert np.all(res.conval < chi0)
    assert res.n_moves.min() > 0
    delta = suite.orientation_error(res.contribs)
    assert delta < 0.3, f"orientation off by {delta:.2f} rad"


def test_2d_full_api_fit():
    d = synth_2d(n_q=16, n_psi=8)
    bound = get_model("CylindersRadiallyIsotropic").bind(**BIND)
    cfg = McSASConfig(num_contribs=10, num_reps=2, max_iterations=1000,
                      chunk_steps=250, candidates_per_step=2, seed=4,
                      max_retries=0, show_incomplete=True)
    res = mt.fit(d, model=bound, cfg=cfg, device="cpu")
    assert np.all(np.isfinite(res.engine.conval))
    assert len(res.histograms) == 2
    assert np.isfinite(res.fractions.measval).all()
    assert res.fractions.measval.shape == (2, d.count)


# ---------------------------------------------- against the JAX package

def _engines(image, name="CylindersRadiallyIsotropic", bind=None):
    d, jd = image
    bind = BIND if bind is None else bind
    base = dict(num_contribs=20, num_reps=2, chunk_steps=50,
                candidates_per_step=4, seed=3, max_retries=0)
    je = jax_engine.McSASEngine(jd, jax_get_model(name).bind(**bind),
                                JaxConfig(use_pallas="off", **base))
    te = McSASEngine(d, get_model(name).bind(**bind), McSASConfig(**base),
                     device="cpu")
    return je, te


@pytest.mark.parametrize("name,bind", [
    ("CylindersRadiallyIsotropic", BIND),
    ("CylindersRadiallyIsotropicTilted",
     dict(active=("radius", "psiAngle"),
          active_ranges={"radius": (1.0, 20.0)}))])
def test_2d_normalization_and_rows_match_jax(image, name, bind):
    """The 2D magnitude probe (ff2d at the ranges' geometric midpoint on
    the image's (q, ψ) pairs) and w_ref equal JAX's to 1e-13; the engine's
    float32 rows (ff2d·√w)² equal JAX's to 1e-5 relative with a floor of
    1e-6 of each row's maximum (float32 sin/cos a few ulps apart)."""
    d, jd = image
    je, te = _engines(image, name, bind)
    assert not te.uses_table and te.kern.psi is not None
    ours = magnitude_probe(te.bound, d.q, two_d_psi=d.psi)
    ref = jax_engine.magnitude_probe(je.bound, jd.q, two_d_psi=jd.psi)
    assert ours == pytest.approx(ref, rel=1e-13)
    assert te.w_ref == pytest.approx(je.w_ref, rel=1e-13)
    rs = np.random.default_rng(5)
    params = np.stack([rs.uniform(lo, hi, 40) for lo, hi in te.bound.ranges],
                      axis=1).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p: je._intensity_row(je.grid, p))(
        jnp.asarray(params)))[:, :d.count]
    got = te.kern.row(torch.as_tensor(params)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    floor = 1e-6 * np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + floor)


def _close(a, b, rtol=1e-10):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    finite = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), finite)
    scale = np.maximum(np.abs(b), 1e-300)
    assert np.all(np.abs(a - b)[finite] <= rtol * scale[finite])


def test_2d_post_pass_matches_jax(image):
    """The 2D float64 post pass (the bank ff2d²·w on the (q, ψ) pairs,
    solve, curves, aGoFs, observability) and the fractions on the same
    contributions as JAX's: 1e-10 relative."""
    d, jd = image
    rs = np.random.default_rng(21)
    contribs = np.stack([rs.uniform(2e-9, 2e-8, (3, 30)),
                         rs.uniform(0.01, 6.0, (3, 30))], axis=-1)
    b, jb = (get_model("CylindersRadiallyIsotropic").bind(**BIND),
             jax_get_model("CylindersRadiallyIsotropic").bind(**BIND))
    cfg, jcfg = (McSASConfig(num_contribs=30, num_reps=3),
                 JaxConfig(num_contribs=30, num_reps=3))
    ours = histogram._post_pass_f64(b, d, cfg, contribs)
    ref = jax_hist._post_pass_f64(jb, jd, jcfg, contribs)
    for a, r in zip(ours, ref):
        _close(a, np.broadcast_to(r, np.shape(a)))
    # in blocks of 7 contributions: the same bank, to 1e-15 relative (the
    # CPU's vectorized sin/cos and its scalar tail, which the block size
    # moves, may differ in the last bit)
    blocked = histogram._post_pass_f64(b, d, cfg, contribs, bank_block=7)
    for a, r in zip(blocked, ours):
        _close(a, r, rtol=1e-15)
    fo = histogram.compute_fractions(contribs, d, b, cfg, device="cpu")
    fr = jax_hist.compute_fractions(contribs, jd, jb, jcfg)
    for w in histogram.WEIGHTINGS:
        _close(fo.fraction[w], fr.fraction[w])
        _close(fo.min_req[w], fr.min_req[w])
    _close(fo.measval, fr.measval)


def test_2d_ignores_smearing_with_a_warning(image, caplog):
    """2D data loaded with a smearing config: a model with ff2d that can
    smear fits the unsmeared 2D rows and logs a warning (the JAX
    package's rule, mcsas_tpu/core/engine.py:191-195)."""
    d, _ = image
    smeared = data.from_raw(
        np.column_stack([d.q / 1e9, d.f, d.fu, np.degrees(d.psi)]),
        config=data.DataConfig(n_bin=0, fit_2d=True,
                               smearing=data.TrapezoidSmearing(
                                   do_smear=True, n_steps=3, umbra=0.05e9,
                                   penumbra=0.2e9)))
    assert smeared.uses_smearing and smeared.psi is not None
    model = dataclasses.replace(get_model("CylindersRadiallyIsotropic"),
                                can_smear=True)
    cfg = McSASConfig(num_contribs=8, num_reps=1, chunk_steps=8,
                      candidates_per_step=2)
    with caplog.at_level(logging.WARNING):
        eng = McSASEngine(smeared, model.bind(**BIND), cfg, device="cpu")
    assert "ignores the smearing config" in caplog.text
    plain = McSASEngine(d, model.bind(**BIND), cfg, device="cpu")
    assert eng.kern.locs is None and eng.kern.psi is not None
    pv = torch.tensor([[5e-9, 0.8], [1.5e-8, 2.0]], dtype=torch.float32)
    assert torch.equal(eng.kern.row(pv), plain.kern.row(pv))


def test_2d_has_no_kernel(image):
    """2D takes no table and no kernel: the plain chunk on the CPU, and
    use_pallas='on' refused naming 2D and use_pallas='off'."""
    d, _ = image
    bound = get_model("CylindersRadiallyIsotropic").bind(**BIND)
    cfg = McSASConfig(num_contribs=8, num_reps=1, chunk_steps=8,
                      candidates_per_step=2, table_ff="on")
    eng = McSASEngine(d, bound, cfg, device="cpu")
    assert not eng.uses_table and eng.prefetch_entry is None
    assert not eng.runs_cuda_kernel
    with pytest.raises(ValueError, match="2D") as err:
        McSASEngine(d, bound, cfg.replace(use_pallas="on"), device="cpu")
    assert "use_pallas='off'" in str(err.value)


def test_2d_golden_row(image):
    """The suite's 'cylinders-2d' image: 100 q × 36 ψ, 1 % uncertainty,
    the same construction as the small image (its first 24 q and 16 ψ
    at those sizes)."""
    big = suite.cylinder_2d_golden()
    assert big.count == 3600 and big.psi.shape == (3600,)
    np.testing.assert_allclose(big.fu, 0.01 * big.f, rtol=1e-12)
    d, _ = image
    again = suite.cylinder_2d_golden(24, 16, rel_sigma=0.02)
    np.testing.assert_array_equal(again.f, d.f)
