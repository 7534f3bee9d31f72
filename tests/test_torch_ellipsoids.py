# -*- coding: utf-8 -*-
"""PyTorch port, the ellipsoid table models: EllipsoidsIsotropic and
EllipsoidalCoreShell — their form factors with the orientation axis
behind batched parameters, their tables (unsmeared and smeared), the rows
K2's table entry blends, the route each binding takes and the slice as a
whole, held against the JAX package on the same inputs.  Tables are baked
at 16 nodes an axis (MCSAS_TPU_TABLE_RES_CAP), 8 for the three-axis
core-shell table, unless a test says otherwise; the production table's
accuracy is tests/test_torch_table_accuracy.py's."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcsas_tpu import data as jax_data  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402
from mcsas_tpu.core import engine as jax_engine  # noqa: E402
from mcsas_tpu.models import ellipsoids as jax_ell  # noqa: E402
from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu.ops import tables as jax_tables  # noqa: E402
from mcsas_tpu.post import histogram as jax_hist  # noqa: E402
from mcsas_tpu_torch import data, fit  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.io import load_raw  # noqa: E402
from mcsas_tpu_torch.models import ellipsoids, get_model  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel, tables  # noqa: E402
from mcsas_tpu_torch.post import histogram  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
NM = 1e-9
SLD = dict(eta_c=3.15e14, eta_s=2.53e14, eta_sol=0.0)
# the suite rows' bindings (bench.py:160-161,173-175,213-214)
ELL = dict(active=("a",), active_ranges={"a": (0.5 * NM, 300 * NM)},
           fixed={"aspect": 3.0})
ELL2 = dict(active=("a", "aspect"),
            active_ranges={"a": (0.5 * NM, 300 * NM), "aspect": (0.5, 5.0)})
ECS = dict(active=("a", "t"),
           active_ranges={"a": (2 * NM, 50 * NM), "t": (10 * NM, 200 * NM)},
           fixed={"b": 15 * NM})
ECS3 = dict(active=("a", "b", "t"))
BINDINGS = {"ell-1": ("EllipsoidsIsotropic", ELL),
            "ell-2": ("EllipsoidsIsotropic", ELL2),
            "ecs-2": ("EllipsoidalCoreShell", ECS),
            "ecs-3": ("EllipsoidalCoreShell", ECS3)}


@pytest.fixture(scope="module", autouse=True)
def small_tables():
    """16 nodes a table axis for the whole module, no disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
        mp.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
        yield


def _cap(key, monkeypatch):
    """8 nodes an axis for the three-axis table (512 rows)."""
    if key == "ecs-3":
        monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "8")


def _q():
    return np.geomspace(0.01, 3.0, 40) * 1e9


# ----------------------------------------------------------- form factors

@pytest.mark.parametrize("use_aspect", [1.0, 0.0])
def test_ellipsoid_ff_matches_jax(use_aspect):
    """float64 ff of one spheroid, c from a·aspect or c itself; tolerance
    1e-13 relative (the same trapezoid mean in another summation order)."""
    p = dict(a=8e-9, c=25e-9, aspect=3.0, useAspect=use_aspect,
             intDiv=100.0, sld=1e-6)
    q = _q()
    ours = ellipsoids._ell_iso_ff(torch.as_tensor(q), p).numpy()
    ref = np.asarray(jax.jit(lambda qq: jax_ell._ell_iso_ff(qq, p))(q))
    np.testing.assert_allclose(ours, ref, rtol=1e-13)


def test_core_shell_ellipsoid_ff_matches_jax():
    """float64 ff of one core-shell ellipsoid (the JAX package's outer
    product of q and the μ rule); tolerance 1e-13 relative."""
    p = dict(a=10e-9, b=15e-9, t=50e-9, intDiv=100.0, **SLD)
    q = _q()
    ours = ellipsoids._ell_cs_ff(torch.as_tensor(q), p).numpy()
    ref = np.asarray(jax.jit(lambda qq: jax_ell._ell_cs_ff(qq, p))(q))
    np.testing.assert_allclose(ours, ref, rtol=1e-13)


@pytest.mark.parametrize("grid", ["fit", "offsets"])
@pytest.mark.parametrize("name", ["EllipsoidsIsotropic",
                                  "EllipsoidalCoreShell"])
def test_ff_batched_matches_jax_vmap(name, grid):
    """Contributions as (B, 1) entries against the fit grid and (B, 1, 1)
    against the (Nq, n_off) smearing offsets, as the float64 bank passes
    them, the orientation axis appended last: against JAX's ff of one
    contribution vmapped over them; tolerance 1e-13 relative."""
    rs = np.random.default_rng(4)
    q = _q()
    qg = q if grid == "fit" else np.outer(q, [0.95, 1.0, 1.05])
    model, jmodel = get_model(name), jax_get_model(name)
    active = ("a", "c") if name == "EllipsoidsIsotropic" else ("a", "b",
                                                               "t")
    bound = model.bind(active=active, fixed={"useAspect": 0.0}
                       if name == "EllipsoidsIsotropic" else None)
    jbound = jmodel.bind(active=active, fixed={"useAspect": 0.0}
                         if name == "EllipsoidsIsotropic" else None)
    vals = rs.uniform(5e-9, 60e-9, (6, len(active)))
    tv = torch.as_tensor(vals)
    pv = tv[:, None, :] if grid == "fit" else tv[:, None, None, :]
    ours = model.ff(torch.as_tensor(qg), bound.pdict(pv)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(lambda v: jmodel.ff(
        jnp.asarray(qg.ravel()), jbound.pdict(v))))(vals))
    assert ours.shape == (len(vals), *qg.shape)
    np.testing.assert_allclose(ours.reshape(len(vals), -1), ref,
                               rtol=1e-13)


@pytest.mark.parametrize("name", ["EllipsoidsIsotropic",
                                  "EllipsoidalCoreShell"])
def test_volume_and_reference_volume_match_jax(name):
    """Volumes (absvolume with the SLD for the spheroid) with JAX's
    integer-power order, and the host reference volume: to 1e-15."""
    active = (("a", "c") if name == "EllipsoidsIsotropic"
              else ("a", "b", "t"))
    fixed = {"useAspect": 0.0} if name == "EllipsoidsIsotropic" else None
    ours_b = get_model(name).bind(active=active, fixed=fixed)
    ref_b = jax_get_model(name).bind(active=active, fixed=fixed)
    pv = np.random.default_rng(3).uniform(1e-9, 1e-7, (20, len(active)))
    for fn in ("volume", "absvolume"):
        ours = np.asarray(getattr(ours_b, fn)(torch.as_tensor(pv)))
        ref = np.asarray([float(getattr(ref_b, fn)(jnp.asarray(p)))
                          for p in pv])
        np.testing.assert_allclose(ours, ref, rtol=1e-15)
    for bind in ({}, ELL if name == "EllipsoidsIsotropic" else ECS):
        assert get_model(name).bind(**bind).reference_volume() == \
            pytest.approx(jax_get_model(name).bind(
                **bind).reference_volume(), rel=1e-15)


def test_ellipsoidal_core_shell_golden(refmodeldata):
    """The JAX package's test_ellipsoidal_core_shell_golden: SASfit's
    curve at a = 100, b = 150, t = 500 (nm units), normalized, mean
    absolute deviation < 1e-2."""
    raw, _ = load_raw(
        refmodeldata / "EllCoreShell_a100_b150_t500_c3p16_s2p53_sol0.csv")
    q, i_ref = raw[:, 0], raw[:, 1]
    p = dict(a=100.0, b=150.0, t=500.0, eta_c=3.16, eta_s=2.53,
             eta_sol=0.0, intDiv=100.0)
    i = ellipsoids._ell_cs_ff(torch.as_tensor(q), p).numpy() ** 2
    rel = np.abs(i_ref / i_ref.max() - i / i.max())
    assert np.mean(rel) < 1e-2


# ----------------------------------------------------------- the tables

def _slit(mod):
    return mod.DataConfig(smearing=mod.TrapezoidSmearing(
        do_smear=True, n_steps=5, umbra=0.05e9, penumbra=0.2e9))


@pytest.mark.parametrize("smear", [False, True], ids=["plain", "smeared"])
@pytest.mark.parametrize("key", sorted(BINDINGS))
def test_bake_matches_jax(refdata, key, smear, monkeypatch):
    """The float32 tables of every binding against JAX's bake, unsmeared
    and smeared (the intensity ff²(locs) @ smear_w, in blocks of 8 rows).
    Tolerance 2e-5 relative with a floor of 1e-6 of the largest value:
    both run the same n=801 (spheroid) or n=201 (core-shell) rule in
    float32; the libraries' sin/cos/sqrt differ in the last ulp and the
    node sums run in another order."""
    name, bind = BINDINGS[key]
    _cap(key, monkeypatch)
    d = data.load(refdata / "sasfit_sphere-10-1.dat",
                  config=_slit(data) if smear else None)
    bound, jbound = get_model(name).bind(**bind), \
        jax_get_model(name).bind(**bind)
    kw = {} if not smear else {"smear": (np.asarray(d.locs),
                                         np.asarray(d.smear_w))}
    made = bound.model.ff_table_factory(bound, np.asarray(d.q),
                                        torch.float32, torch.device("cpu"),
                                        **kw)
    ref = jbound.model.ff_table_factory(jbound, np.asarray(d.q),
                                        jnp.float32, **kw)
    assert len(made) == len(ref) == (3 if smear else 2)
    ours, want = made[1].values.numpy(), np.asarray(ref[1])
    n_axes = len(made[0].tab_params)
    assert ours.shape == want.shape == ((8 if n_axes == 3 else 16) ** n_axes,
                                        d.count)
    np.testing.assert_allclose(ours, want, rtol=2e-5,
                               atol=1e-6 * np.abs(want).max())


def _engines(refdata, key, smear=False):
    """The JAX engine and the port's CPU engine of one binding on its
    table, on the sphere dataset (smeared: a slit of 6 offsets)."""
    name, bind = BINDINGS[key]
    path = refdata / "sasfit_sphere-10-1.dat"
    kw = dict(num_reps=3, num_contribs=20, candidates_per_step=8, seed=7)
    je = jax_engine.McSASEngine(
        jax_data.load(path, config=_slit(jax_data) if smear else None),
        jax_get_model(name).bind(**bind), JaxConfig(**kw))
    te = McSASEngine(data.load(path, config=_slit(data) if smear else None),
                     get_model(name).bind(**bind),
                     McSASConfig(table_ff="on", **kw), device="cpu")
    assert je.uses_table and te.uses_table
    return je, te


def _jax_table(je, nq):
    vals = np.asarray(je.grid[1])[:, :nq]
    for tab in jax_tables._TABLE_CACHE.values():
        if (isinstance(tab, jax_tables.ParamTable)
                and tab.values.shape == vals.shape
                and np.array_equal(np.asarray(tab.values), vals)):
            return np.asarray(tab.values), tab.axes
    raise AssertionError("the JAX engine's table is not in its memo")


@pytest.mark.parametrize("smear", [False, True], ids=["plain", "smeared"])
@pytest.mark.parametrize("key", sorted(BINDINGS))
def test_engine_rows_match_jax(refdata, key, smear, monkeypatch):
    """IntensityKernel.row against JAX's engine row, amplitude tables
    ((blend·√w)²) and smeared intensity tables (blend·w).  On JAX's own
    table: 1e-5 relative (the float32 log of the lookup and the 1/v_ref
    scaling may each differ by an ulp); on the port's bake 5e-5 (the
    bake's 2e-5 enters squared); a floor of 1e-6 of each row's maximum."""
    _cap(key, monkeypatch)
    je, te = _engines(refdata, key, smear)
    assert te.w_ref == pytest.approx(je.w_ref, rel=1e-13)
    assert te.kern.table_is_intensity == smear
    nq = te.consts.n
    values, axes = _jax_table(je, nq)
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
    assert np.all(np.abs(on_ours - ref) <= 5e-5 * np.abs(ref) + floor)


@pytest.mark.parametrize("key,entry", [("ell-1", "table"),
                                       ("ell-2", "table"),
                                       ("ecs-2", "table"),
                                       ("ecs-3", "rows")])
def test_routes_to_k2_entries(refdata, key, entry, monkeypatch):
    """The spheroid at one or two axes and the core-shell ellipsoid at two
    take K2's table entry (plain make_lookup tables, no factor); the
    core-shell ellipsoid with a, b and t active has three axes and takes
    the rows-in entry.  On the CPU both run the plain version, which a
    segment of the engine equals."""
    _cap(key, monkeypatch)
    _, te = _engines(refdata, key)
    assert te.prefetch_entry == mc_kernel.prefetch_entry(te) == entry
    if entry == "table":
        assert te.spec.factor_layout == (0, -1, 0.0)
        assert len(te.spec.table_layout) == len(te.bound.active)
    else:
        assert "at most 2 table axes" in mc_kernel.table_blend_refusal(
            te.kern)
    te.gen.manual_seed(3)
    state = te._init_batch()
    gen_state = te.gen.get_state()
    cands = mc_kernel.segment_candidates(
        state, 0, te.spec, te._draw_chunk_proposals(te.seg_steps))
    want, _ = mc_kernel.prefetch_reference(
        state.clone(), 0, te.consts, te.spec, te.kern.row(cands), cands)
    te.gen.set_state(gen_state)
    got, _ = te._segment(state.clone(), 0)
    assert int(got.n_moves.sum()) > 0
    for k in ("rset", "ibank", "ft", "conval", "n_moves", "n_iter"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(want, k).numpy())


# ------------------------------------------------------------- the slice

def _bench():
    with pytest.MonkeyPatch.context() as mp:
        # importing bench defaults the table disk cache into the repo
        mp.setenv("MCSAS_TPU_TABLE_CACHE_DIR", "")
        spec = importlib.util.spec_from_file_location("bench",
                                                      REPO / "bench.py")
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
    return bench


@pytest.mark.parametrize("kind,ours", [
    ("ellipsoid", suite.ellipsoid_golden),
    ("ellcoreshell", suite.core_shell_ellipsoid_golden)])
def test_goldens_match_bench(kind, ours):
    """The suite rows' synthetic goldens, built with the port's float64
    functions, against bench.synth_golden; tolerance 1e-12 relative (the
    same n=801 rules in float64)."""
    ref = _bench().synth_golden(kind)
    got = ours()
    np.testing.assert_allclose(got.q, ref.q, rtol=1e-15)
    np.testing.assert_allclose(got.f, ref.f, rtol=1e-12)
    np.testing.assert_allclose(got.fu, ref.fu, rtol=1e-12)
    assert got.count == ref.count == 100


def test_suite_rows_bind_as_bench():
    """The three table rows carry bench.py's bindings, budgets and local
    moves (bench.py:155-222)."""
    rows = suite.TABLE_ROWS
    assert set(rows) == {"ellipsoids-isotropic", "core-shell-ellipsoid",
                         "kholodenko-worm"}
    ell = rows["ellipsoids-isotropic"]
    b = ell.bound(ell.load())
    assert b.active == ("a",) and dict(b.fixed)["aspect"] == 3.0
    assert b.ranges == ((0.5 * NM, 300 * NM),)
    ecs = rows["core-shell-ellipsoid"]
    b = ecs.bound(ecs.load())
    assert b.active == ("a", "t") and dict(b.fixed)["b"] == 15 * NM
    worm = rows["kholodenko-worm"]
    b = worm.bound(worm.load())
    assert b.active == ("radius", "lenKuhn", "lenContour")
    assert [(r.k_cand, r.budget, r.local_moves) for r in rows.values()] == [
        (128, 8_000_000, 0.0), (128, 40_000_000, 0.5),
        (128, 24_000_000, 0.75)]
    cfg = ecs.config()
    assert (cfg.num_contribs, cfg.num_reps, cfg.seed, cfg.max_retries,
            cfg.chunk_steps) == (300, 10, 2026, 1, 1024)


@pytest.mark.parametrize("name", ["ellipsoids-isotropic",
                                  "core-shell-ellipsoid"])
def test_fit_and_post_pass_on_the_cpu(name, monkeypatch):
    """fit() of each ellipsoid row's golden on the table tier converges
    on the CPU (the spheroid's vol-weighted mean a within 10 % of its 10
    nm), and the float64 post pass of its contributions gives JAX's
    histograms and moments (RTOL 1e-9: float64 on both sides).  Cut
    against the suite rows: 3 repetitions of 60 contributions, K=32, a
    table of 256 rows (spheroid) or 32 × 32 with a in 5-20 nm and t in
    30-80 nm around the golden's 10 and 50 (core-shell: its 2-50 × 10-200
    nm box at 32 × 32 nodes interpolates coarser than the data's 1 %)."""
    row = suite.TABLE_ROWS[name]
    ranges = dict(row.ranges)
    if name == "ellipsoids-isotropic":
        monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "256")
    else:
        monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "32")
        ranges = {"a": (5 * NM, 20 * NM), "t": (30 * NM, 80 * NM)}
    d = row.load()
    bound = get_model(row.model).bind(active=row.active,
                                      active_ranges=ranges, fixed=row.fixed)
    cfg = row.config(num_contribs=60, num_reps=3, candidates_per_step=32,
                     max_iterations=2_000_000)
    res = fit(d, bound, cfg, device="cpu")
    e = res.engine
    assert res.converged and e.conval.max() <= 1.0
    assert e.used_table and not e.used_pallas
    if name == "ellipsoids-isotropic":
        mean_a = float(res.histograms[0].moments.mean[0])
        assert abs(mean_a - 10 * NM) <= 0.1 * 10 * NM
    jd = jax_data.from_raw(np.column_stack([d.q * 1e-9, d.f, d.fu]),
                           config=jax_data.DataConfig(n_bin=0))
    jb = jax_get_model(row.model).bind(active=row.active,
                                       active_ranges=ranges, fixed=row.fixed)
    jcfg = JaxConfig(num_contribs=60, num_reps=3)
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
