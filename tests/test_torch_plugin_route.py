# -*- coding: utf-8 -*-
"""PyTorch port: an elementwise plugin model — a model that declares
``elementwise_q`` and has no device function of K1 — runs through K2's
rows-in entry, its rows evaluated by its own ``ff`` before the launch.
That is the JAX package's K1 gate (mcsas_tpu/ops/mc_kernel.py:38-44)
applied to the models K1 has no device function for.  On the CPU the
route runs K2's plain version (``prefetch_reference`` on
``segment_rows``); the kernel is held to it on the card
(tests/test_torch_cuda.py, chip_smoke.py).

The plugins are the port's Sphere as a plugin (the same ``ff`` and
``volume`` on another model object, so K1 cannot take it) and a plugin
of the form factor (q·r)⁻² with a sphere's volume."""
import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcsas_tpu import data as jax_data  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402
from mcsas_tpu.core import engine as jax_engine  # noqa: E402
from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu.models.base import ParamSpec as JaxParamSpec  # noqa: E402
from mcsas_tpu.models.base import SASModel as JaxSASModel  # noqa: E402
from mcsas_tpu.utils.units import NM as JAX_NM  # noqa: E402
from mcsas_tpu_torch import api, data, fit  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import (McSASEngine,  # noqa: E402
                                         state_from_numpy, state_to_numpy)
from mcsas_tpu_torch.models import (REGISTRY, ParamSpec,  # noqa: E402
                                    SASModel, get_model, register_model)
from mcsas_tpu_torch.ops import mc_kernel  # noqa: E402
from mcsas_tpu_torch.parallel import make_mesh  # noqa: E402
from mcsas_tpu_torch.post.histogram import HistogramSpec  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402
from mcsas_tpu_torch.utils.units import NM  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_tables as ttt  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
SPHERE10 = REPO / "testdata" / "sasfit_sphere-10-1.dat"
FIXTURE = REPO / "testdata" / "reference_sphere10_fixture.json"
_SMALL = dict(num_contribs=32, num_reps=2, candidates_per_step=8,
              local_moves=0.5, seed=3, max_retries=0)


def sphere_plugin():
    """The port's Sphere as a plugin: not the registry's object."""
    return dataclasses.replace(get_model("Sphere"), name="SpherePlugin")


def inverse_square_plugin(mod=None):
    """ff = (q·r)⁻², a sphere's volume, in the port (or, with *mod* =
    (SASModel, ParamSpec, NM) of the JAX package, on jnp)."""
    model_cls, spec_cls, nm = mod or (SASModel, ParamSpec, NM)
    return model_cls(
        name="InverseSquare", elementwise_q=True, doc="plugin",
        params=(spec_cls("radius", nm.to_si(1.0), nm, (0.0, float("inf")),
                         active_range=nm.to_si((0.1, 100.0)),
                         generator="logdec1", is_fit=True),),
        default_active=("radius",),
        ff=lambda q, p: (q * p["radius"]) ** -2,
        volume=lambda p: 4.0 / 3.0 * math.pi * p["radius"] ** 3)


def _engine(model, d=None, **kw):
    cfg = McSASConfig(**dict(_SMALL, **kw))
    return McSASEngine(data.load(SPHERE10) if d is None else d,
                       model.bind(), cfg, device="cpu")


# ------------------------------------------------------------ (a) routing

@pytest.mark.parametrize("shape", ("small", "headline"))
def test_elementwise_plugin_takes_the_rows_entry(shape):
    """The plugin's route: K2's rows entry, no K1, no table; its segment
    by the JAX package's cap (chunk size, N with local moves, 64 MiB of
    (S, R, K, Nq) rows on the fit grid), which is the JAX package's own
    segment wherever its lane padding of Nq does not bind."""
    kw = ({} if shape == "small" else
          dict(num_contribs=300, num_reps=10, candidates_per_step=128,
               chunk_steps=2048))
    eng = _engine(sphere_plugin(), **kw)
    assert eng.prefetch_entry == "rows" and eng.runs_prefetch
    assert not mc_kernel.supports(eng) and not eng.uses_table
    assert mc_kernel.supports_prefetch(eng) and eng._kernel_eligible()
    cfg = eng.cfg
    per_step = cfg.num_reps * cfg.candidates_per_step * eng.consts.n * 4
    want = min(cfg.chunk_steps, cfg.num_contribs,
               mc_kernel.PREFETCH_ROW_BYTES // per_step)
    assert eng.seg_steps == want == (32 if shape == "small" else 131)
    # a prewarm builds and loads K2's library for this route
    assert set(eng.prewarm()) == {"nvcc mc_prefetch", "load mc_prefetch",
                                  "init", "attributes mc_prefetch"}
    if shape == "small":
        je = jax_engine.McSASEngine(
            jax_data.load(SPHERE10),
            dataclasses.replace(jax_get_model("Sphere"),
                                name="SpherePlugin").bind(),
            JaxConfig(use_pallas="on", **_SMALL))
        from mcsas_tpu.ops import mc_kernel as jax_mc_kernel
        assert je.uses_pallas
        assert eng.seg_steps == jax_mc_kernel.prefetch_seg_steps(je)
    # the built-in keeps K1; use_pallas='off' keeps the plain chunk
    assert mc_kernel.supports(_engine(get_model("Sphere"), **kw))
    off = _engine(sphere_plugin(), use_pallas="off", **kw)
    assert off.prefetch_entry == "rows" and not off.runs_prefetch
    assert off.seg_steps is None


def _refused(case):
    """(engine factory, the words the error must hold) of a configuration
    the JAX package's K1 refuses, so that it runs its XLA scan."""
    if case == "smeared":
        d = data.load(SPHERE10, config=data.DataConfig(
            smearing=data.TrapezoidSmearing(
                do_smear=True, n_steps=5, umbra=0.05e9, penumbra=0.2e9)))
        return (lambda **kw: _engine(sphere_plugin(), d, **kw)), "smeared"
    if case == "float64":
        return (lambda **kw: _engine(sphere_plugin(), dtype="float64",
                                     **kw)), "float64"
    if case == "2d":
        model = dataclasses.replace(
            get_model("CylindersRadiallyIsotropic"), name="Plugin2D",
            elementwise_q=True)
        d = suite.cylinder_2d_golden(n_q=8, n_psi=4)
        return (lambda **kw: _engine(model, d, **kw)), "2D"
    model = dataclasses.replace(inverse_square_plugin(), elementwise_q=False)
    return (lambda **kw: _engine(model, **kw)), "no device function"


@pytest.mark.parametrize("case", ("smeared", "float64", "2d",
                                  "not-elementwise"))
def test_refused_plugins_still_raise(case):
    """What the JAX package's K1 refuses stays without a kernel: no K2
    entry, and use_pallas='on' raises naming the reason; 'off' builds
    the plain chunk."""
    make, reason = _refused(case)
    with pytest.raises(ValueError, match="not eligible") as err:
        make(use_pallas="on")
    assert reason in str(err.value) and "use_pallas='off'" in str(err.value)
    eng = make(use_pallas="off")
    assert eng.prefetch_entry is None and not eng.runs_prefetch
    assert not mc_kernel.elementwise_eligible(eng)
    assert reason in eng._no_kernel_reason()


def test_plugin_under_a_builtin_name_keeps_its_own_engine(monkeypatch):
    """A field-for-field copy of Sphere registered as 'Sphere' is no
    model K1 has a device function for: it takes the rows entry, and
    fit()'s engine cache keeps its engine apart from the built-in's."""
    monkeypatch.setattr(api, "_ENGINE_CACHE", {})
    builtin = get_model("Sphere")
    copy = dataclasses.replace(builtin)
    assert copy == builtin and copy is not builtin
    d = data.load(SPHERE10)
    cfg = McSASConfig(**_SMALL)
    saved = REGISTRY["Sphere"]
    register_model(copy, overwrite=True)
    try:
        ours = api._cached_engine(McSASEngine, d, get_model("Sphere").bind(),
                                  cfg, "cpu")
    finally:
        REGISTRY["Sphere"] = saved
    theirs = api._cached_engine(McSASEngine, d, builtin.bind(), cfg, "cpu")
    assert ours is not theirs
    assert ours.prefetch_entry == "rows" and ours.runs_prefetch
    assert theirs.prefetch_entry is None and mc_kernel.supports(theirs)


# --------------------------------------------------------------- (b) rows

def _jax_rows(jax_model, cands, **kw):
    """JAX's ``_intensity_row`` of each candidate (..., P), float32."""
    je = jax_engine.McSASEngine(jax_data.load(SPHERE10), jax_model.bind(),
                                JaxConfig(**dict(_SMALL, **kw)))
    flat = jnp.asarray(cands.reshape(-1, cands.shape[-1]).numpy())
    rows = jax.jit(jax.vmap(lambda p: je._intensity_row(je.grid, p)))(flat)
    return np.asarray(rows).reshape(*cands.shape[:-1], -1)


@pytest.mark.parametrize("plugin", ("sphere", "inverse-square"))
def test_segment_rows_are_the_rows_of_each_step(plugin):
    """segment_rows of a whole segment is kern.row of each step bit for
    bit (whole CPU vectors: a row does not depend on its batch), and
    JAX's row of the same formula: (q·r)⁻² to 1e-6 relative (the two
    libraries' float32 pow differ in the last ulp); the sphere by the
    rule of test_torch_engine.py's rows, 1e-5 relative with a floor of
    1e-6 of each row's largest value (sin and cos differ in the last ulp,
    which the cancellation of 3(sin x − x cos x)/x³ at small x and near
    the form factor's zeros amplifies)."""
    model = (sphere_plugin() if plugin == "sphere"
             else inverse_square_plugin())
    eng = _engine(model)
    eng.gen.manual_seed(11)
    state = eng._init_batch()
    cands = mc_kernel.segment_candidates(
        state, 0, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    rows = mc_kernel.segment_rows(eng.spec, cands)
    assert rows.shape == (eng.seg_steps, 2, 8, eng.consts.n)
    for s in range(eng.seg_steps):
        assert torch.equal(rows[s], eng.kern.row(cands[s])), s
    jax_model = (dataclasses.replace(jax_get_model("Sphere"),
                                     name="SpherePlugin")
                 if plugin == "sphere" else
                 inverse_square_plugin((JaxSASModel, JaxParamSpec, JAX_NM)))
    ref = _jax_rows(jax_model, cands)
    if plugin == "sphere":
        tol = 1e-5 * np.abs(ref) + 1e-6 * np.abs(ref).max(axis=-1,
                                                          keepdims=True)
    else:
        tol = 1e-6 * np.abs(ref)
    assert np.all(np.abs(rows.numpy() - ref) <= tol)


# --------------------------------------------------- (c) the twin vs JAX

@pytest.fixture(scope="module", params=["global", "local"])
def plugin_pair(request):
    """One segment of the plugin from the same JAX-initialized state on
    JAX's own proposal stream: JAX's ``_step`` of an engine with
    use_pallas='on' (K1 eligible, the grid lane-padded) applied one step
    at a time — the semantics JAX's K1 implements, whose in-kernel
    stream cannot be injected — and ``prefetch_reference`` on
    ``segment_rows`` of the same proposals, with its trace."""
    n, r = ttt.N, 4
    kw = dict(num_reps=r, num_contribs=n, convergence_criterion=2.0,
              max_iterations=200000, chunk_steps=64, candidates_per_step=8,
              seed=7, max_retries=0)
    if request.param == "local":
        kw["local_moves"] = 0.5
    je = jax_engine.McSASEngine(
        jax_data.load(SPHERE10),
        dataclasses.replace(jax_get_model("Sphere"),
                            name="SpherePlugin").bind(),
        JaxConfig(use_pallas="on", **kw))
    te = McSASEngine(data.load(SPHERE10), sphere_plugin().bind(),
                     McSASConfig(**kw), device="cpu")
    assert je.uses_pallas and te.prefetch_entry == "rows"
    nq, seg = te.consts.n, te.seg_steps
    assert seg == (n if request.param == "local" else 64)
    state = je._init_batch(jax.random.split(jax.random.PRNGKey(0), r))
    keys = jax.vmap(jax.random.split)(state.key)
    props = np.asarray(je._draw_chunk_proposals(keys[:, 1], n_steps=seg),
                       np.float32)
    step = jax.jit(lambda s, c, ri: jax.vmap(
        lambda sr, cr: je._step(sr, cr, ri))(s, c))
    js = state._replace(ft=jnp.sum(state.ibank, axis=1))
    j_steps = []
    for s in range(seg):
        js = step(js, jnp.asarray(props[s]), jnp.asarray(s % n, jnp.int32))
        j_steps.append(ttt._numpy(js, nq))
    start = ttt._numpy(state, nq)
    t_state = state_from_numpy(start)
    cands = mc_kernel.segment_candidates(t_state, 0, te.spec,
                                         torch.tensor(props))
    rows = mc_kernel.segment_rows(te.spec, cands)
    trace = {}
    t_final, t_ri = mc_kernel.prefetch_reference(t_state, 0, te.consts,
                                                 te.spec, rows, cands, trace)
    return dict(te=te, spec=te.spec, cands=cands, rows=rows, start=start,
                j_steps=j_steps, t_final=state_to_numpy(t_final), t_ri=t_ri,
                seg=seg, trace=trace)


def test_plugin_twin_matches_jax_k1_semantics(plugin_pair):
    """Exact decisions against JAX's step on the same state and
    proposals, by the rule of test_torch_tables.py's K2 twin: a decision
    may flip only at a near-tie (relative χ² gap ≤ NEAR_TIE), the first
    flip must be one, and the trajectories agree up to it; without a
    flip the whole segment matches."""
    run = plugin_pair
    assert run["t_final"]["n_moves"].min() > 0
    flip = ttt._first_flip(run)
    if flip is None:
        ttt._assert_states_match(run["t_final"], run["j_steps"][-1],
                                 run["t_ri"], run["seg"] % ttt.N)
        return
    s, r = flip
    tr = run["trace"]
    margin = float(mc_kernel.decision_margin(tr["chi"][s, r],
                                             tr["conval"][s, r]))
    assert margin <= ttt.NEAR_TIE, (s, r, margin)
    assert s > 0
    upto, ri = mc_kernel.prefetch_reference(
        state_from_numpy(run["start"]), 0, run["te"].consts, run["spec"],
        run["rows"][:s].contiguous(), run["cands"][:s].contiguous())
    ttt._assert_states_match(state_to_numpy(upto), run["j_steps"][s - 1],
                             ri, s % ttt.N)


# ------------------------------------------ (d) the slice, (e) the mesh

@pytest.fixture(scope="module")
def plugin_fit():
    """A small fit() of the Sphere plugin on the CPU (its rows route)."""
    return fit(SPHERE10, sphere_plugin(), McSASConfig(**_SMALL),
               device="cpu")


def _vol_bars(res):
    """The volume-weighted radius histogram on the reference fixture's
    bins, normalized to sum 1, and its mean radius."""
    fix = json.loads(FIXTURE.read_text())
    lo, hi = fix["workload"]["activeRange_m"]
    n_bins = len(fix["histograms"]["vol"]["yMean"])
    h = res.histogram([HistogramSpec("radius", lo, hi, bin_count=n_bins,
                                     xscale="log", yweight="vol",
                                     auto_follow=False)]).histograms[0]
    return h.bins.mean / h.bins.mean.sum(), float(h.moments.mean[0])


def test_plugin_fit_agrees_with_the_builtin_sphere(plugin_fit):
    """The plugin's fit converges, and its distribution agrees with the
    built-in Sphere's fit (K1's plain version, another proposal stream)
    on the same data: volume-weighted bars within 0.2 of each other (the
    headline's bar tolerance against the reference) and mean radii
    within 5 %."""
    res = plugin_fit
    assert res.engine.converged.all() and res.engine.conval.max() <= 1.0
    assert not res.engine.used_prefetch and not res.engine.used_table
    builtin = fit(SPHERE10, "Sphere", McSASConfig(**_SMALL), device="cpu")
    assert builtin.engine.converged.all()
    bars, mean = _vol_bars(res)
    ref_bars, ref_mean = _vol_bars(builtin)
    assert np.max(np.abs(bars - ref_bars)) <= 0.2
    assert abs(mean - ref_mean) <= 0.05 * ref_mean


def test_plugin_rep_mesh_is_bitwise_the_unsharded_fit(plugin_fit):
    """Two repetition shards (CPU devices) of the plugin's fit: each
    shard runs its slice of every segment, bitwise the unsharded fit."""
    res = fit(SPHERE10, sphere_plugin(), McSASConfig(**_SMALL),
              mesh=make_mesh((2, 1), [torch.device("cpu")] * 2))
    assert len(res.engine.contribs) == 2
    for f in ("contribs", "conval", "n_iter", "n_moves", "attempts",
              "converged", "scaling", "background", "measval"):
        np.testing.assert_array_equal(getattr(res.engine, f),
                                      getattr(plugin_fit.engine, f),
                                      err_msg=f)
    assert res.engine.total_iters == plugin_fit.engine.total_iters


def test_plugin_q_axis_keeps_the_plain_chunk():
    """On a q axis no kernel sums across the shards: the plugin's engine
    runs the plain chunk there, as the JAX package runs its scan, and
    use_pallas='on' raises naming the q axis."""
    from mcsas_tpu_torch.parallel import ShardedEnsemble
    mesh = make_mesh((1, 2), [torch.device("cpu")] * 2)
    se = ShardedEnsemble(data.load(SPHERE10), sphere_plugin().bind(),
                         McSASConfig(**_SMALL), mesh=mesh)
    assert se.prefetch_entry == "rows" and not se.runs_prefetch
    assert se.seg_steps is None and not se.runs_cuda_kernel
    with pytest.raises(ValueError, match="q axis"):
        ShardedEnsemble(data.load(SPHERE10), sphere_plugin().bind(),
                        McSASConfig(**_SMALL, use_pallas="on"), mesh=mesh)
