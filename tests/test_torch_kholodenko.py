# -*- coding: utf-8 -*-
"""PyTorch port, the Kholodenko worm: the sine integral, the converged
Filon/Boole rule batched over contributions, the form factor, the table
over (lenKuhn, lenContour) with the cross-section as a factor of each
point, the rows K2's table entry computes, the plain K2 and the slice as a
whole, held against the JAX package on the same inputs.  Tables are baked
at 16 nodes an axis (MCSAS_TPU_TABLE_RES_CAP) unless a test says
otherwise; the production table's accuracy is
tests/test_torch_table_accuracy.py's."""
import dataclasses
import math

import numpy as np
import pytest
import scipy.integrate
import scipy.special

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcsas_tpu import data as jax_data  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402
from mcsas_tpu.core import engine as jax_engine  # noqa: E402
from mcsas_tpu.models import chains as jax_chains  # noqa: E402
from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu.ops import mc_kernel as jax_mc_kernel  # noqa: E402
from mcsas_tpu.ops import special as jax_special  # noqa: E402
from mcsas_tpu.ops import tables as jax_tables  # noqa: E402
from mcsas_tpu.post import histogram as jax_hist  # noqa: E402
from mcsas_tpu_torch import data, fit  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import (McSASEngine,  # noqa: E402
                                         state_from_numpy, state_to_numpy)
from mcsas_tpu_torch.io import load_raw  # noqa: E402
from mcsas_tpu_torch.models import chains, get_model  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel, special, tables  # noqa: E402
from mcsas_tpu_torch.post import histogram  # noqa: E402

R, N = 4, 50
NEAR_TIE = 1e-6    # relative χ² gap below which summation order may flip
KHO = "sasfit_kho-1-10-1000.dat"
# (radius, lenKuhn, lenContour) in m: the golden's, and two inside the
# default ranges, one with x = 3·contour/kuhn below Z_CUT = 40
PARAMS = [(1e-9, 10e-9, 1000e-9), (3e-9, 30e-9, 200e-9),
          (2e-9, 50e-9, 100e-9)]


@pytest.fixture(scope="module", autouse=True)
def small_tables():
    """16 nodes a table axis for the whole module, no disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
        mp.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
        yield


def _q():
    return np.geomspace(0.01, 3.0, 40) * 1e9


# ------------------------------------------------------- special functions

def test_sine_integral_matches_jax_and_scipy():
    """Si over both branches (Taylor below 6, Gauss-Laguerre above):
    against JAX's to 1e-14 relative (the same rule; the 64 nodes are
    summed in order here, by a pairwise tree there) and against
    scipy.special.sici at the JAX test's limits."""
    y = np.concatenate([np.linspace(0.0, 8.0, 300),
                        np.geomspace(8.0, 1e4, 200)])
    ours = special.sine_integral(torch.as_tensor(y)).numpy()
    ref = np.asarray(jax.jit(jax_special.sine_integral)(y))
    np.testing.assert_allclose(ours, ref, rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(ours, scipy.special.sici(y)[0], rtol=5e-13,
                               atol=5e-13)


def test_gauss_legendre_equals_jax():
    for n, panels in ((16, 128), (8, 8), (16, 32), (5, 1)):
        for a, b in zip(special.gauss_legendre(n, panels),
                        jax_special.gauss_legendre(n, panels)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ form factor

@pytest.mark.parametrize("p", PARAMS)
def test_ff_matches_jax(p):
    """float64 ff of one contribution against JAX's scalar-x rule;
    tolerance 1e-12 relative (the same operations, the 513-step
    recurrence in the same order; the libraries' sin/sinh differ in the
    last ulp)."""
    pd = dict(zip(("radius", "lenKuhn", "lenContour"), p))
    q = _q()
    ours = chains._kho_ff(torch.as_tensor(q), pd).numpy()
    ref = np.asarray(jax.jit(lambda qq: jax_chains._kho_ff(qq, pd))(q))
    np.testing.assert_allclose(ours, ref, rtol=1e-12)


def test_ff_batched_matches_jax_vmap():
    """Contributions as (B, 1) entries, as the float64 bank passes them:
    the converged rule batched over x, each row on its own node grid,
    against JAX's scalar rule vmapped over the contributions (the JAX
    package's post pass); tolerance 1e-12 relative."""
    vals = np.asarray(PARAMS + [(1.5e-9, 12e-9, 300e-9)], np.float64)
    q = _q()
    pd = {n: torch.as_tensor(vals[:, i:i + 1])
          for i, n in enumerate(("radius", "lenKuhn", "lenContour"))}
    ours = chains._kho_ff(torch.as_tensor(q), pd).numpy()

    def one(v):
        return jax_chains._kho_ff(jnp.asarray(q), dict(
            radius=v[0], lenKuhn=v[1], lenContour=v[2]))

    ref = np.asarray(jax.jit(jax.vmap(one))(vals))
    assert ours.shape == ref.shape == (len(vals), len(q))
    np.testing.assert_allclose(ours, ref, rtol=1e-12)


@pytest.mark.parametrize("p", PARAMS)
def test_ff_fast_matches_jax(p):
    """The float32 fit-grade rule (512 + 64 Gauss-Legendre nodes) against
    JAX's; tolerance 2e-6 relative with a floor of 1e-6 of the largest
    value (float32 sums of 576 nodes in another order)."""
    pd = dict(zip(("radius", "lenKuhn", "lenContour"), p))
    q = _q().astype(np.float32)
    ours = chains._kho_ff_fast(torch.as_tensor(q), pd).numpy()
    ref = np.asarray(jax.jit(lambda qq: jax_chains._kho_ff_fast(qq, pd))(q))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=2e-6,
                               atol=1e-6 * np.abs(ref).max())


def test_volume_and_reference_volume_match_jax():
    """π·L·r² with JAX's integer-power order: to 1e-15."""
    rs = np.random.default_rng(3)
    bind = dict(active=("radius", "lenKuhn", "lenContour"))
    ours_b, ref_b = get_model("Kholodenko").bind(**bind), \
        jax_get_model("Kholodenko").bind(**bind)
    pv = rs.uniform(1e-9, 1e-6, (20, 3))
    for fn in ("volume", "absvolume"):
        ours = np.asarray(getattr(ours_b, fn)(torch.as_tensor(pv)))
        ref = np.asarray([float(getattr(ref_b, fn)(jnp.asarray(p)))
                          for p in pv])
        np.testing.assert_allclose(ours, ref, rtol=1e-15)
    assert ours_b.reference_volume() == pytest.approx(
        ref_b.reference_volume(), rel=1e-15)


def test_kholodenko_golden(refdata):
    """The JAX package's test_kholodenko_golden: SASfit's curve at r = 1,
    kuhn = 10, contour = 1000 (nm units), mean relative error < 1e-5."""
    raw, _ = load_raw(refdata / KHO)
    q, i_ref = raw[:, 0], raw[:, 1]
    p = dict(radius=1.0, lenKuhn=10.0, lenContour=1000.0)
    i = chains._kho_ff(torch.as_tensor(q), p).numpy() ** 2
    rel = np.abs((i_ref - i) / i_ref)
    assert rel.mean() < 1e-5


def _quad_p0_sq(t, x):
    """∫₀ˣ f(z)·(2/x)(1−z/x) dz by adaptive quadrature (the JAX test's)."""
    def f(z):
        if z <= 1e-300:
            return 2.0 / x
        if t < 1:
            e = math.sqrt(1 - t * t)
            fz = (math.sinh(e * z) / (e * math.sinh(z)) if z < 500
                  else math.exp((e - 1) * z) / e)
        else:
            F = math.sqrt(t * t - 1)
            fz = math.sin(F * z) / (F * math.sinh(z))
        return fz * (2.0 / x) * (1.0 - z / x)
    val, _ = scipy.integrate.quad(f, 0, x, limit=5000, epsabs=1e-14,
                                  epsrel=1e-12)
    return val


def test_conv_rule_vs_adaptive_quad():
    """The JAX package's test_kholodenko_conv_rule_vs_adaptive_quad, with
    the four x values as one (4, 1) batch (each on its own node grid):
    frequencies up to F ≈ 167 and x on both sides of Z_CUT, ≤ 1e-6."""
    ts = np.array([0.01, 0.5, 0.95, 0.9999, 1.0001, 1.2, 2.0, 10.0, 60.0,
                   167.0])
    xs = np.array([6.0, 39.5, 40.5, 300.0])
    got = chains._kho_p0_sq_conv(torch.as_tensor(ts),
                                 torch.as_tensor(xs[:, None])).numpy()
    assert got.shape == (len(xs), len(ts))
    for row, x in zip(got, xs):
        want = np.array([_quad_p0_sq(t, x) for t in ts])
        np.testing.assert_allclose(row, want, rtol=1e-6, atol=1e-14)


def test_kholodenko_vs_adaptive_quad():
    """The JAX package's test_kholodenko_vs_adaptive_quad: ff against
    adaptive quadrature of the reference's integrand (its t = 1 case
    z/sinh z included), 1e-5 relative."""
    kuhn, contour = 12e-9, 300e-9
    qs = np.array([1e7, 3e8 / kuhn / 10, 3.0 / kuhn, 5e8, 1e9])
    x = 3.0 * contour / kuhn

    def core(z, qv):
        if z <= 0:
            return 1.0
        ratio = 3.0 / kuhn
        if qv < ratio:
            e = math.sqrt(1 - qv ** 2 * kuhn ** 2 / 9.0)
            fz = (math.sinh(e * z) / (e * math.sinh(z)) if z < 500
                  else math.exp((e - 1) * z) / e)
        elif qv > ratio:
            f = math.sqrt(qv ** 2 * kuhn ** 2 / 9.0 - 1.0)
            fz = math.sin(f * z) / (f * math.sinh(z))
        else:
            fz = z / math.sinh(z)
        return fz * (2.0 / x) * (1.0 - z / x)

    p = dict(radius=1e-9, lenKuhn=kuhn, lenContour=contour)
    got = chains._kho_ff(torch.as_tensor(qs), p).numpy()
    for i, qv in enumerate(qs):
        ref, _ = scipy.integrate.quad(core, 0, x, args=(qv,), limit=10000,
                                      epsabs=0.0, epsrel=1e-10)
        pcs = 2.0 * scipy.special.j1(qv * 1e-9) / (qv * 1e-9)
        assert got[i] == pytest.approx(math.sqrt(max(ref, 0.0)) * pcs,
                                       rel=1e-5)


# ----------------------------------------------------- table, rows, route

def _slit(mod):
    return mod.DataConfig(smearing=mod.TrapezoidSmearing(
        do_smear=True, n_steps=5, umbra=0.05e9, penumbra=0.2e9))


def _config(**kw):
    base = dict(num_reps=R, num_contribs=N, convergence_criterion=2.0,
                max_iterations=200000, chunk_steps=64,
                candidates_per_step=8, seed=7, max_retries=0)
    base.update(kw)
    return base


def _engines(refdata, smear=False, bind=None, **kw):
    """The JAX engine (use_pallas 'on': K2 in interpret mode; smeared:
    'auto', its K2 refuses the smeared worm's lane-padded rows) and the
    port's CPU engine of the worm on its table, on the golden's data."""
    path = refdata / KHO
    bind = bind or {}
    jd = jax_data.load(path, config=_slit(jax_data) if smear else None)
    td = data.load(path, config=_slit(data) if smear else None)
    je = jax_engine.McSASEngine(
        jd, jax_get_model("Kholodenko").bind(**bind),
        JaxConfig(**_config(use_pallas="auto" if smear else "on", **kw)))
    te = McSASEngine(td, get_model("Kholodenko").bind(**bind),
                     McSASConfig(**_config(table_ff="on", **kw)),
                     device="cpu")
    assert je.uses_table and te.uses_table
    assert te.kern.table_is_intensity == smear
    return je, te


def _jax_table(je, width):
    """The JAX engine's baked table (values and axes) from its memo."""
    vals = np.asarray(je.grid[1])[:, :width]
    for tab in jax_tables._TABLE_CACHE.values():
        if (isinstance(tab, jax_tables.ParamTable)
                and tab.values.shape == vals.shape
                and np.array_equal(np.asarray(tab.values), vals)):
            return np.asarray(tab.values), tab.axes
    raise AssertionError("the JAX engine's table is not in its memo")


@pytest.mark.parametrize("smear", [False, True], ids=["plain", "smeared"])
def test_bake_matches_jax(refdata, smear):
    """The float32 table of the backbone p0, unsmeared (on the fit grid)
    and smeared (on the flattened (Nq, 6) offsets), against JAX's bake.
    Tolerance 5e-5 relative with a floor of 1e-6 of the largest value:
    both run the 513-step recurrence in float32 in the same order, and a
    last-ulp difference of the two libraries' sin/sinh/exp at its start
    is carried through 513 rotations."""
    bound = get_model("Kholodenko").bind()
    jbound = jax_get_model("Kholodenko").bind()
    d = data.load(refdata / KHO, config=_slit(data) if smear else None)
    kw = {} if not smear else {"smear": (np.asarray(d.locs),
                                         np.asarray(d.smear_w))}
    made = bound.model.ff_table_factory(bound, np.asarray(d.q),
                                        torch.float32, torch.device("cpu"),
                                        **kw)
    ref = jbound.model.ff_table_factory(jbound, np.asarray(d.q),
                                        jnp.float32, **kw)
    assert len(made) == len(ref) == (3 if smear else 2)
    ours, want = made[1].values.numpy(), np.asarray(ref[1])
    width = d.count * (6 if smear else 1)
    assert ours.shape == want.shape == (16 * 16, width)
    np.testing.assert_allclose(ours, want, rtol=5e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("smear", [False, True], ids=["plain", "smeared"])
def test_engine_rows_match_jax(refdata, smear):
    """IntensityKernel.row of the worm (blend·cross-section, squared with
    w; smeared: the cross-section at each offset, contracted, times w)
    against JAX's engine row.  On JAX's own table: 1e-5 relative (the
    lookup's float32 log, the cross-section's divisions and the 1/v_ref
    scaling may each differ by an ulp); on the port's bake 1e-4 (the
    bake's 5e-5 enters squared); a floor of 1e-6 of each row's maximum."""
    je, te = _engines(refdata, smear=smear)
    assert te.w_ref == pytest.approx(je.w_ref, rel=1e-13)
    nq = te.consts.n
    values, axes = _jax_table(je, te.kern.table.values.shape[1])
    rs = np.random.default_rng(5)
    params = np.stack([np.exp(rs.uniform(np.log(lo), np.log(hi), 40))
                       for lo, hi in te.bound.ranges], axis=1)
    params = np.concatenate([[[lo for lo, _ in te.bound.ranges],
                              [hi for _, hi in te.bound.ranges]],
                             params]).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda p: je._intensity_row(je.grid, p))(
        jnp.asarray(params)))[:, :nq]
    floor = 1e-6 * np.max(np.abs(ref), axis=1, keepdims=True)
    kern = dataclasses.replace(
        te.kern, table=tables.table_from_numpy(values, axes))
    on_jax = kern.row(torch.as_tensor(params)).numpy()
    on_ours = te.kern.row(torch.as_tensor(params)).numpy()
    assert on_ours.dtype == np.float32 and on_ours.shape == ref.shape
    assert np.all(np.abs(on_jax - ref) <= 1e-5 * np.abs(ref) + floor)
    assert np.all(np.abs(on_ours - ref) <= 1e-4 * np.abs(ref) + floor)


def test_routes_to_k2_entries(refdata):
    """The worm's table goes through K2's table entry with its
    cross-section as a declared factor (its radius an active column, or a
    fixed value); the smeared worm's lookup declares nothing and its rows
    (Nq wide after the contraction) go through the rows-in entry; a
    factor K2 does not know, or one on an intensity table, sends a table
    to the rows-in entry too."""
    d = data.load(refdata / KHO)
    cfg = McSASConfig(**_config(table_ff="on"))
    worm = McSASEngine(d, get_model("Kholodenko").bind(), cfg, device="cpu")
    assert worm.prefetch_entry == mc_kernel.prefetch_entry(worm) == "table"
    assert worm.kern.table_fn.row_factor == ("cross_section", "radius")
    assert worm.spec.factor_layout == (1, 0, 0.0)
    assert [ax[0] for ax in worm.spec.table_layout] == [1, 2]
    fixed = McSASEngine(d, get_model("Kholodenko").bind(
        active=("lenKuhn", "lenContour"), fixed={"radius": 2e-9}), cfg,
        device="cpu")
    assert fixed.prefetch_entry == "table"
    assert fixed.spec.factor_layout == (1, -1, 2e-9)
    _, smeared = _engines(refdata, smear=True)
    assert smeared.prefetch_entry == "rows"
    assert not hasattr(smeared.kern.table_fn, "row_factor")

    def declaring(kind):
        lookup = worm.kern.table_fn

        def fn(table, pdict):
            return lookup(table, pdict)
        fn.tab_params = lookup.tab_params
        fn.row_factor = (kind, "radius")
        return fn

    unknown = dataclasses.replace(worm.kern, table_fn=declaring("sinc"))
    assert "row factors" in mc_kernel.table_blend_refusal(unknown)
    on_intensity = dataclasses.replace(
        worm.kern, table_fn=declaring("cross_section"),
        table_is_intensity=True)
    assert "amplitudes only" in mc_kernel.table_blend_refusal(on_intensity)
    worm.kern = unknown
    assert mc_kernel.prefetch_entry(worm) == "rows"


def test_smeared_rows_in_blocks_equal_the_whole(refdata, monkeypatch):
    """segment_rows evaluates the smeared worm's lookup (rows Nq·6 wide
    before the contraction) in blocks of steps of each repetition: the
    blocks give the whole segment's rows within 2e-6 relative (a floor of
    1e-7 of the largest row value; the contraction over the offsets is a
    matrix product, which may sum in another order at another batch
    size), and the rows-in segment of the engine equals prefetch_reference
    on the blocked rows bit for bit."""
    _, te = _engines(refdata, smear=True)
    te.gen.manual_seed(2)
    state = te._init_batch()
    gen_state = te.gen.get_state()
    cands = mc_kernel.segment_candidates(
        state, 0, te.spec, te._draw_chunk_proposals(te.seg_steps))
    whole = te.kern.row(cands)
    monkeypatch.setattr(mc_kernel, "ROWS_BLOCK_VALUES",
                        3 * cands.shape[2] * te.kern.table.values.shape[1])
    blocked = mc_kernel.segment_rows(te.spec, cands)
    assert cands.shape[0] * cands.shape[1] > 3
    assert blocked.shape == whole.shape
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=2e-6,
                               atol=1e-7 * float(whole.abs().max()))
    want, _ = mc_kernel.prefetch_reference(state.clone(), 0, te.consts,
                                           te.spec, blocked, cands)
    te.gen.set_state(gen_state)
    got, _ = te._segment(state.clone(), 0)
    assert int(got.n_moves.sum()) > 0
    for k, v in state_to_numpy(want).items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v)


# ------------------------------------------------------------------ K2

def _numpy(state, nq):
    out = {k: np.asarray(getattr(state, k)) for k in state._fields
           if k != "key"}
    out["ibank"] = out["ibank"][..., :nq]
    out["ft"] = out["ft"][..., :nq]
    return out


@pytest.mark.parametrize("mode", ["global", "local"])
def test_prefetch_twin_matches_jax_k2(refdata, mode):
    """One worm segment from the same JAX-initialized state on JAX's own
    proposal stream and JAX's table: ``prefetch_table_reference`` (the
    plain version of K2's table entry with the factor) against JAX's K2
    in interpret mode.  A decision may flip only at a near-tie (the
    solve's sums associate differently), and the trajectories must agree
    exactly up to it; tolerances as the cylinder's twin test: counters
    exact, parameters 1e-6, χ² 1e-5, ft 2e-4 relative."""
    kw = {"local_moves": 0.5} if mode == "local" else {}
    je, te = _engines(refdata, **kw)
    nq = te.consts.n
    seg = mc_kernel.prefetch_seg_steps(te)
    assert seg == jax_mc_kernel.prefetch_seg_steps(je)
    kern = dataclasses.replace(
        te.kern, table=tables.table_from_numpy(*_jax_table(je, nq)))
    spec = dataclasses.replace(te.spec, kern=kern)
    state = je._init_batch(jax.random.split(jax.random.PRNGKey(0), R))
    keys = jax.vmap(jax.random.split)(state.key)
    props = np.asarray(je._draw_chunk_proposals(keys[:, 1], n_steps=seg),
                       np.float32)
    j_final, j_ri = je._chunk_batch(state, jnp.zeros((), jnp.int32))
    step = jax.jit(lambda s, c, ri: jax.vmap(
        lambda sr, cr: je._step(sr, cr, ri))(s, c))
    js = state._replace(ft=jnp.sum(state.ibank, axis=1))
    j_steps = []
    for s in range(seg):
        js = step(js, jnp.asarray(props[s]), jnp.asarray(s % N, jnp.int32))
        j_steps.append(_numpy(js, nq))
    start = _numpy(state, nq)
    cands = mc_kernel.segment_candidates(state_from_numpy(start), 0, spec,
                                         torch.tensor(props))
    trace = {}
    t_final, t_ri = mc_kernel.prefetch_table_reference(
        state_from_numpy(start), 0, te.consts, spec, cands, trace)
    t_final = state_to_numpy(t_final)
    assert t_final["n_moves"].min() > 0
    flip, prev = None, start["n_moves"]
    for s, jst in enumerate(j_steps):
        j_acc = jst["n_moves"] > prev
        prev = jst["n_moves"]
        bad = (j_acc != (trace["choice"][s].numpy() >= 0)) | ~np.all(
            np.isclose(jst["rset"][:, s % N, :], trace["slot"][s].numpy(),
                       rtol=1e-6, atol=0.0), axis=1)
        if bad.any():
            flip = s, int(np.argmax(bad))
            break

    def match(ours, ref, ri_ours, ri_ref):
        assert ri_ours == ri_ref
        np.testing.assert_array_equal(ours["n_moves"], ref["n_moves"])
        np.testing.assert_array_equal(ours["n_iter"], ref["n_iter"])
        np.testing.assert_allclose(ours["rset"], ref["rset"], rtol=1e-6)
        np.testing.assert_allclose(ours["conval"], ref["conval"], rtol=1e-5)
        np.testing.assert_allclose(ours["ft"], ref["ft"], rtol=2e-4,
                                   atol=2e-4 * np.abs(ref["ft"]).max())

    if flip is None:
        match(t_final, _numpy(j_final, nq), t_ri, int(j_ri))
        return
    s, r = flip
    margin = float(mc_kernel.decision_margin(trace["chi"][s, r],
                                             trace["conval"][s, r]))
    assert margin <= NEAR_TIE and s > 0, (s, r, margin)
    upto, ri = mc_kernel.prefetch_table_reference(
        state_from_numpy(start), 0, te.consts, spec, cands[:s].contiguous())
    match(state_to_numpy(upto), j_steps[s - 1], ri, s % N)


# ------------------------------------------------------------- the slice

def test_worm_fit_and_post_pass_on_the_cpu(refdata, monkeypatch):
    """fit() of the worm row's data on the table tier converges on the
    CPU, and the float64 post pass of its contributions gives JAX's
    histograms and moments (RTOL 1e-9: float64 on both sides, the
    recurrence's sums in the same order, the solve's in another).  Cut
    against the suite row: 3 repetitions of 40 contributions, K=16 with
    local moves 0.75, a 64 × 64 table."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
    d = data.load(refdata / KHO)
    bound = get_model("Kholodenko").bind()
    cfg = McSASConfig(num_contribs=40, num_reps=3, max_iterations=2_000_000,
                      chunk_steps=1024, candidates_per_step=16, seed=2026,
                      max_retries=1, local_moves=0.75)
    res = fit(d, bound, cfg, device="cpu")
    e = res.engine
    assert res.converged and e.conval.max() <= 1.0
    assert e.used_table and not e.used_pallas
    assert np.isfinite(res.fractions.measval).all()
    jb = jax_get_model("Kholodenko").bind()
    jd = jax_data.load(refdata / KHO)
    jcfg = JaxConfig(num_contribs=40, num_reps=3)
    specs = [histogram.HistogramSpec(n, lo, hi, bin_count=10, xscale="log",
                                     yweight=w)
             for n, (lo, hi) in zip(bound.active, bound.ranges)
             for w in ("vol", "num")]
    jspecs = [jax_hist.HistogramSpec(s.param, s.lower, s.upper,
                                     bin_count=10, xscale="log",
                                     yweight=s.yweight) for s in specs]
    _, ours = histogram.histogram_all(e.contribs, d, bound, cfg, specs)
    _, ref = jax_hist.histogram_all(e.contribs, jd, jb, jcfg, jspecs)
    for h, jh in zip(ours, ref):
        np.testing.assert_array_equal(h.x_lower_edge, jh.x_lower_edge)
        np.testing.assert_allclose(h.bins.full, jh.bins.full, rtol=1e-9,
                                   atol=1e-300)
        a, b = np.asarray(h.moments.fields), np.asarray(jh.moments.fields)
        scale = np.maximum(np.repeat(np.abs(b[0::2]), 2), np.abs(b))
        assert np.all(np.abs(a - b) <= 1e-9 * scale)
