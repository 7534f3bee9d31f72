# -*- coding: utf-8 -*-
"""PyTorch port: intensity rows, the plain chunk (the CUDA kernel's twin)
and the engine loop, held against the JAX package's XLA scan path — the
semantics oracle — on the same data, initial state and proposals."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcsas_tpu import api as jax_api  # noqa: E402
from mcsas_tpu import data as jax_data  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402
from mcsas_tpu.core import engine as jax_engine  # noqa: E402
from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu_torch import api, data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import (McSASEngine,  # noqa: E402
                                         magnitude_probe, state_from_numpy,
                                         state_to_numpy)
from mcsas_tpu_torch.core.fitcore import solve_scale_bg  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel  # noqa: E402

N, R, STEPS = 40, 2, 250
NEAR_TIE = 1e-6    # relative χ² gap below which summation order may flip


@pytest.fixture(scope="module")
def sphere_path(refdata):
    return refdata / "sasfit_sphere-10-1.dat"


def _engines(path, model="Sphere", active=None, ranges=None, **kw):
    """The JAX and port engines of *model* (its default active set, or
    *active* with the SI *ranges*) on the data at *path*; unbounded
    ranges defaulted from the data by each package's own
    ``_default_unbounded_ranges``."""
    base = dict(num_contribs=N, num_reps=R, max_iterations=100_000,
                chunk_steps=STEPS, seed=11, max_retries=0, use_pallas="off")
    base.update(kw)
    jd, td = jax_data.load(path), data.load(path)
    jb = jax_api._default_unbounded_ranges(
        jax_get_model(model).bind(active=active, active_ranges=ranges), jd)
    tb = api._default_unbounded_ranges(
        get_model(model).bind(active=active, active_ranges=ranges), td)
    assert tb.ranges == jb.ranges and tb.fixed == jb.fixed
    je = jax_engine.McSASEngine(jd, jb, JaxConfig(**base))
    te = McSASEngine(td, tb, McSASConfig(**base), device="cpu")
    return je, te


def _jax_state_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in state._fields
            if k != "key"}


# ------------------------------------------------------ intensity rows

def test_normalization_matches_jax(sphere_path):
    je, te = _engines(sphere_path)
    assert te.w_ref == pytest.approx(je.w_ref, rel=1e-13)
    assert magnitude_probe(te.bound, te.data.q) == pytest.approx(
        jax_engine.magnitude_probe(je.bound, je.data.q), rel=1e-13)
    np.testing.assert_array_equal(te.grid.numpy(), np.asarray(je.grid))
    np.testing.assert_array_equal(te.consts.u.numpy(),
                                  np.asarray(je.consts.u))


def _rows_both(je, te, params):
    ours = te.kern.row(torch.as_tensor(params)).numpy()
    ref = np.asarray(jax.vmap(lambda p: je._intensity_row(je.grid, p))(
        jnp.asarray(params)))
    return ours, ref


def test_intensity_rows_match_jax(sphere_path):
    # tolerance: float32 rows agree to 1e-5 relative with a floor of 1e-6
    # of each row's maximum (sin/cos differ in the last ulp, which the
    # cancellation near the form factor's zeros amplifies there)
    je, te = _engines(sphere_path)
    lo, hi = te.bound.ranges[0]
    rs = np.random.default_rng(4)
    params = np.concatenate([[[lo], [hi]], rs.uniform(lo, hi, (62, 1))])
    ours, ref = _rows_both(je, te, params.astype(np.float32))
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    floor = 1e-6 * np.max(np.abs(ref), axis=1, keepdims=True)
    assert np.all(np.abs(ours - ref) <= 1e-5 * np.abs(ref) + floor)


def test_row_clamp_matches_jax():
    # σ ~ 1e-13 puts the float32 overflow clamp at its 1e3 floor, and
    # large radii on a low-q grid reach it: both packages must clamp the
    # same entries at the same value (the host float64 formula, divided
    # by num_contribs)
    q = np.logspace(-3, -1, 60)                        # nm⁻¹
    i = 1e-14 * (1.0 + q ** -2)
    raw = np.column_stack([q, i, 0.01 * i])
    je = jax_engine.McSASEngine(
        jax_data.from_raw(raw), jax_get_model("Sphere").bind(),
        JaxConfig(num_contribs=300, num_reps=1, use_pallas="off"))
    te = McSASEngine(data.from_raw(raw), get_model("Sphere").bind(),
                     McSASConfig(num_contribs=300, num_reps=1),
                     device="cpu")
    assert te.kern.row_clamp == 1e3
    params = np.linspace(1e-7, 1e-6, 16, dtype=np.float32)[:, None]
    ours, ref = _rows_both(je, te, params)
    clamped = ref == np.float32(te.kern.row_clamp)
    assert clamped.any() and not clamped.all()
    np.testing.assert_array_equal(ours == np.float32(1e3), clamped)


# ------------------------------------------ the plain chunk against JAX

_SPHERE = "sasfit_sphere-10-1.dat"
_GAUSS = "sasfit_gauss2-5-1.5-2-1.dat"
_CORE_SHELL = "models/SphCoreShell_R100_dR150_c3p16_s2p53.csv"
# Sphere, and the other models K1 runs on their bench suite rows' data:
# the row's active set (the P=2 ones with local moves 0.5, as the rows
# run them) and a second one, K=8; ft_drift: see _assert_states_match
_CHUNKS = {
    "k4-global": dict(candidates_per_step=4),
    "k8-local": dict(candidates_per_step=8, local_moves=0.5),
    "lma-suite-k8-local": dict(
        model="LMADenseSphere", active=("radius", "volFrac"),
        ranges={"volFrac": (1e-4, 0.1)}, candidates_per_step=8,
        local_moves=0.5),
    "lma-radius-k8": dict(model="LMADenseSphere", candidates_per_step=8,
                          ft_drift=True),
    "gauss-rg-k8": dict(data=_GAUSS, model="GaussianChain",
                        candidates_per_step=8, ft_drift=True),
    "gauss-bp-k8": dict(data=_GAUSS, model="GaussianChain", active=("bp",),
                        candidates_per_step=8),
    "coreshell-suite-k8-local": dict(
        data=_CORE_SHELL, model="SphericalCoreShell", active=("radius", "t"),
        candidates_per_step=8, local_moves=0.5),
    "coreshell-radius-k8": dict(data=_CORE_SHELL, model="SphericalCoreShell",
                                candidates_per_step=8),
}


@pytest.fixture(scope="module", params=sorted(_CHUNKS))
def chunk_pair(request, refdata):
    """One 250-step chunk from the same JAX-initialized state on JAX's
    own proposal stream: JAX's ``_run_chunk_batched`` (the oracle), the
    same JAX step applied one step at a time (to locate a flip), and
    ``chunk_reference`` with its trace."""
    return make_chunk_pair(request.param, refdata)


def make_chunk_pair(name, refdata, run=None):
    """The runs of :func:`chunk_pair` for the ``_CHUNKS`` entry *name*;
    *run* ``(te, start, props, trace)`` runs the port's side on a fresh
    state (default: ``chunk_reference``) and returns ``(final, ri)``."""
    kw = dict(_CHUNKS[name])
    ft_drift = kw.pop("ft_drift", False)
    je, te = _engines(refdata / kw.pop("data", _SPHERE), **kw)
    state = je._init_batch(jax.random.split(jax.random.PRNGKey(7), R))
    keys = jax.vmap(jax.random.split)(state.key)
    props = np.asarray(je._draw_chunk_proposals(keys[:, 1]), np.float32)
    j_final, j_ri = jax.jit(je._run_chunk_batched)(
        state, jnp.zeros((), jnp.int32), je.grid, je.consts)

    step = jax.jit(lambda s, c, ri: jax.vmap(
        lambda sr, cr: je._step(sr, cr, ri))(s, c))
    js = state._replace(ft=jnp.sum(state.ibank, axis=1))
    j_steps = []
    for s in range(STEPS):
        js = step(js, jnp.asarray(props[s]), jnp.asarray(s % N, jnp.int32))
        j_steps.append(js)

    start = _jax_state_numpy(state)
    trace = {}
    if run is None:
        t_final, t_ri = mc_kernel.chunk_reference(
            state_from_numpy(start), 0, te.consts, te.spec,
            torch.tensor(props), trace=trace)
    else:
        t_final, t_ri = run(te, start, props, trace)
    return dict(te=te, props=props, start=start, ft_drift=ft_drift,
                j_final=_jax_state_numpy(j_final), j_ri=int(j_ri),
                j_steps=j_steps, t_final=state_to_numpy(t_final),
                t_ri=t_ri, trace=trace)


def _first_flip(run):
    """First (step, rep) where the two trajectories decide differently:
    accept vs reject, or a different accepted parameter."""
    tr = run["trace"]
    prev = run["start"]["n_moves"]
    for s, js in enumerate(run["j_steps"]):
        j_moves = np.asarray(js.n_moves)
        j_acc = j_moves > prev
        prev = j_moves
        t_acc = tr["choice"][s].numpy() >= 0
        j_slot = np.asarray(js.rset)[:, s % N, :]
        t_slot = tr["slot"][s].numpy()
        bad = (j_acc != t_acc) | ~np.all(
            np.isclose(j_slot, t_slot, rtol=1e-6, atol=0.0), axis=1)
        if bad.any():
            return s, int(np.argmax(bad))
    return None


def _assert_states_match(ours, ref, ri_ours, ri_ref, consts,
                         ft_drift=False):
    # tolerances: counters and cursor exact; parameters to 1e-6 relative
    # (one float32 ulp of the accepted proposal); bank rows to 1e-5
    # relative with a floor of 1e-6 of each row's maximum (as the rows
    # themselves); the χ² of each float64 bank sum — the drift-free χ² of
    # the state — to 1e-5.  The running totals: χ² to 1e-5 and ft to 2e-4
    # (the port refreshes ft with a float64 sum, JAX with float32, and the
    # incremental updates then carry that difference along).  With
    # *ft_drift* the running totals are not compared: an initial bank with
    # rows 1e4-1e5 times the final ones makes each package's float32 ft
    # drift by up to ~0.5 % of max|ft| from its bank over a chunk, each
    # its own way
    assert ri_ours == ri_ref
    np.testing.assert_array_equal(ours["n_moves"], ref["n_moves"])
    np.testing.assert_array_equal(ours["n_iter"], ref["n_iter"])
    np.testing.assert_allclose(ours["rset"], ref["rset"], rtol=1e-6)
    floor = 1e-6 * np.abs(ref["ibank"]).max(axis=2, keepdims=True)
    assert np.all(np.abs(ours["ibank"] - ref["ibank"])
                  <= 1e-5 * np.abs(ref["ibank"]) + floor)
    chi = [solve_scale_bg(torch.as_tensor(s["ibank"]).double().sum(1).float(),
                          consts, True, False).chisqr.numpy()
           for s in (ours, ref)]
    np.testing.assert_allclose(chi[0], chi[1], rtol=1e-5)
    if ft_drift:
        return
    np.testing.assert_allclose(ours["conval"], ref["conval"], rtol=1e-5)
    np.testing.assert_allclose(ours["ft"], ref["ft"], rtol=2e-4,
                               atol=2e-4 * np.abs(ref["ft"]).max())


def test_chunk_twin_matches_jax_scan(chunk_pair):
    """Exact decisions against JAX's scan path.  Accept decisions can
    flip where two χ² values are within float32 rounding of each other
    (the two frameworks' sin/cos differ in the last ulp); the first such
    flip must be a near-tie, and the trajectories must agree exactly up
    to it.  Without a flip the whole chunk matches the oracle.  Candidates
    with a NaN χ² are reported: JAX then rejects the whole step (its argmin
    picks the NaN), the port ranks them last by design."""
    run = chunk_pair
    n_nan = int(torch.isnan(run["trace"]["chi"]).sum())
    if n_nan:
        print(f"{n_nan} candidate(s) with a NaN χ² in the chunk")
    te = run["te"]
    flip = _first_flip(run)
    if flip is None:
        _assert_states_match(run["t_final"], run["j_final"], run["t_ri"],
                             run["j_ri"], te.consts, run["ft_drift"])
        return
    s, r = flip
    tr = run["trace"]
    margin = float(mc_kernel.decision_margin(tr["chi"][s, r],
                                             tr["conval"][s, r]))
    print(f"first flip against JAX: step {s}, rep {r}, candidate χ² "
          f"{tr['chi'][s, r].tolist()}, current χ² "
          f"{float(tr['conval'][s, r])}, margin {margin:.3g}")
    assert margin <= NEAR_TIE, (
        f"first flip at step {s}, rep {r} is not a near-tie: margin "
        f"{margin:.3g}, candidate χ² {tr['chi'][s, r].tolist()}, "
        f"current χ² {float(tr['conval'][s, r])}")
    assert s > 0
    # the trajectories agree on everything up to the flip
    upto, ri = mc_kernel.chunk_reference(
        state_from_numpy(run["start"]), 0, te.consts, te.spec,
        torch.tensor(run["props"][:s]))
    _assert_states_match(state_to_numpy(upto),
                         _jax_state_numpy(run["j_steps"][s - 1]), ri, s % N,
                         te.consts, run["ft_drift"])


def test_chunk_twin_invariants(sphere_path):
    """As test_pallas.py holds the TPU kernel: descent, ft = Σ bank,
    χ² = solve(ft), bank rows = row(parameters), parameters in range."""
    _, te = _engines(sphere_path, candidates_per_step=4, use_pallas="auto")
    te.gen.manual_seed(3)
    state = te._init_batch()
    ri = 0
    convals = [state.conval.clone()]
    for _ in range(3):
        state, ri = mc_kernel.run_chunk(
            state, ri, te.consts, te.spec,
            proposals=te._draw_chunk_proposals())
        convals.append(state.conval.clone())
    convals = torch.stack(convals).numpy()
    assert ri == (3 * STEPS) % N
    assert np.all(np.diff(convals, axis=0) <= 0.0)
    assert convals[-1].max() < convals[0].min()
    assert state.n_moves.min() > 0
    np.testing.assert_allclose(state.ft.numpy(),
                               state.ibank.double().sum(1).numpy(),
                               rtol=1e-5)
    sol = solve_scale_bg(state.ibank.double().sum(1).float(), te.consts,
                         True, False)
    np.testing.assert_allclose(sol.chisqr.numpy(), state.conval.numpy(),
                               rtol=1e-4)
    rows = te.kern.row(state.rset).numpy()
    bank = state.ibank.numpy()
    floor = 1e-6 * np.abs(bank).max(axis=2, keepdims=True)
    assert np.all(np.abs(rows - bank) <= 1e-6 * np.abs(bank) + floor)
    lo, hi = te.bound.ranges[0]
    assert state.rset.min() >= np.float32(lo)
    assert state.rset.max() <= np.float32(hi)


def test_decision_margin():
    chi = torch.tensor([[3.0, 2.0, 2.0, 5.0], [1.0, 1.5, 4.0, 9.0]])
    conval = torch.tensor([4.0, 1.0000001])
    m = mc_kernel.decision_margin(chi, conval).numpy()
    assert m[0] == pytest.approx(0.5)        # best 2 vs 3 (duplicates skip)
    assert m[1] <= 2e-7                      # best vs current: one ulp


def test_state_numpy_round_trip(sphere_path):
    _, te = _engines(sphere_path)
    state = te._init_batch()
    back = state_from_numpy(state_to_numpy(state))
    for k, v in state_to_numpy(back).items():
        np.testing.assert_array_equal(v, getattr(state, k).numpy())
    assert back.n_iter.dtype == torch.int32


# ------------------------------------------------------ the wrapper

def test_run_chunk_on_cpu_runs_the_plain_version(sphere_path):
    _, te = _engines(sphere_path, candidates_per_step=4, use_pallas="auto")
    assert mc_kernel.supports(te) and not te.runs_cuda_kernel
    state = te._init_batch()
    props = te._draw_chunk_proposals(n_steps=20)
    a, ri_a = mc_kernel.run_chunk(state.clone(), 5, te.consts, te.spec,
                                  proposals=props)
    b, ri_b = mc_kernel.chunk_reference(state.clone(), 5, te.consts,
                                        te.spec, props)
    before = mc_kernel.run_chunk.launches
    assert ri_a == ri_b == 25
    for k, v in state_to_numpy(a).items():
        np.testing.assert_array_equal(v, getattr(b, k).numpy())
    assert mc_kernel.run_chunk.launches == before   # the kernel never ran


def test_run_chunk_checks_its_arguments(sphere_path):
    _, te = _engines(sphere_path, candidates_per_step=4)
    state = te._init_batch()
    with pytest.raises(ValueError, match="proposals"):
        mc_kernel.run_chunk(state, 0, te.consts, te.spec, seed=1,
                            n_steps=5)
    props = te._draw_chunk_proposals(n_steps=5)
    with pytest.raises(ValueError, match="proposals"):
        mc_kernel.run_chunk(state, 0, te.consts, te.spec,
                            proposals=props.double())
    bad = state.clone()
    bad.n_iter = bad.n_iter.long()
    with pytest.raises(ValueError, match="n_iter"):
        mc_kernel.run_chunk(bad, 0, te.consts, te.spec, proposals=props)
    with pytest.raises(ValueError, match="Sphere|device function"):
        mc_kernel.model_id(object())


def test_run_probe_checks_its_rung_and_group_width(sphere_path):
    """K3's full rung on CPU tensors is the plain chunk; a group width
    other than K1's own runs only the ff and solve rungs, at 8, 16 or 32
    lanes; the checks come before any kernel is built."""
    _, te = _engines(sphere_path, candidates_per_step=4)
    state = te._init_batch()
    props = te._draw_chunk_proposals(n_steps=5)
    a, ri, sink = mc_kernel.run_probe(state.clone(), 2, te.consts, te.spec,
                                      "full", proposals=props)
    b, _ = mc_kernel.chunk_reference(state.clone(), 2, te.consts, te.spec,
                                     props)
    assert ri == 7 and sink is None
    for k, v in state_to_numpy(a).items():
        np.testing.assert_array_equal(v, getattr(b, k).numpy())
    for level, group in (("full", 8), ("rng", 16), ("ff", 4), ("solve", 64),
                         ("writes", 0)):
        with pytest.raises(ValueError, match="group width|probe level"):
            mc_kernel.run_probe(state.clone(), 0, te.consts, te.spec, level,
                                proposals=props, group=group)
        with pytest.raises(ValueError, match="group width|probe level"):
            mc_kernel.launch_shape(state, te.consts, te.spec, level, group)
    with pytest.raises(ValueError, match="measures the CUDA kernel"):
        mc_kernel.run_probe(state.clone(), 0, te.consts, te.spec, "ff",
                            proposals=props, group=8)


def test_philox_matches_known_answers():
    # Random123's published known-answer vectors for Philox4x32-10
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = mc_kernel.philox4x32([np.uint32(c) for c in ctr],
                                   [np.uint32(k) for k in key])
        assert [int(v) for v in got] == list(want)


def test_philox_proposals_contract(sphere_path):
    _, te = _engines(sphere_path, candidates_per_step=8, local_moves=0.5)
    props = mc_kernel.philox_proposals(te.spec, seed=99, n_reps=3,
                                       n_steps=64)
    assert props.shape == (64, 3, 8, 1) and props.dtype == np.float32
    lo, hi = te.bound.ranges[0]
    glob, local = props[:, :, :4], props[:, :, 4:]
    assert glob.min() >= np.float32(lo) and glob.max() <= np.float32(hi)
    assert local.min() >= 0.0 and local.max() < 1.0
    assert not np.array_equal(props[:, 0], props[:, 1])    # per-rep keys
    again = mc_kernel.philox_proposals(te.spec, seed=99, n_reps=3,
                                       n_steps=64)
    np.testing.assert_array_equal(props, again)


# ------------------------------------------------------------ the engine

def test_engine_retries_and_counts(sphere_path):
    # max_iterations = one chunk: every repetition is exhausted after
    # each chunk and retried once (max_retries=0 → 2 attempts)
    _, te = _engines(sphere_path, candidates_per_step=4, chunk_steps=50,
                     max_iterations=200, use_pallas="auto")
    chunks = []
    res = te.run(progress=chunks.append)
    assert list(res.attempts) == [2, 2]
    assert list(res.n_iter) == [200, 200]
    assert res.total_iters == 2 * 2 * 200
    assert not res.converged.any() and not res.used_pallas
    assert len(chunks) == 2
    assert res.measval.shape == (R, te.data.count)
    again = te.run()
    np.testing.assert_array_equal(res.contribs, again.contribs)


def test_engine_stop_hook(sphere_path):
    _, te = _engines(sphere_path, candidates_per_step=4, chunk_steps=30)
    res = te.run(stop=lambda: True)
    assert list(res.n_iter) == [120, 120]
    assert list(res.attempts) == [1, 1]


def test_engine_device_and_tier_policy(sphere_path):
    d = data.load(sphere_path)
    bound = get_model("Sphere").bind()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            McSASEngine(d, bound, McSASConfig(num_contribs=N))
    off = McSASEngine(d, bound, McSASConfig(num_contribs=N,
                                            use_pallas="off"),
                      device="cpu")
    assert not off.runs_cuda_kernel
    with pytest.raises(ValueError, match="eligible"):
        McSASEngine(d, bound, McSASConfig(num_contribs=N, dtype="float64",
                                          use_pallas="on"), device="cpu")
    f64 = McSASEngine(d, bound, McSASConfig(
        num_contribs=N, num_reps=1, dtype="float64", chunk_steps=20,
        max_iterations=80, max_retries=0, candidates_per_step=4),
        device="cpu")
    assert not f64.runs_cuda_kernel
    res = f64.run()
    assert np.isfinite(res.conval).all() and res.n_moves[0] > 0
