# -*- coding: utf-8 -*-
"""PyTorch port: the sharded ensemble (mcsas_tpu_torch/parallel) on CPU
meshes, at the sizes of the JAX package's tests/test_sharding.py (N=30,
R=4, K=2, 1000 steps).

The repetition axis is held bit for bit to the port's unsharded engine on
the same seed (every field of the result); the q axis, whose solve adds
the shards' float64 sums in another order, to the JAX package's near-tie
rule (``assert_contribs_match``), and its solve and plain chunk to the
JAX package's ``psum`` solve and scan on the same inputs."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P  # noqa: E402

from mcsas_tpu.core import fitcore as jax_fitcore  # noqa: E402
from mcsas_tpu_torch import api, cli, data  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core import fitcore  # noqa: E402
from mcsas_tpu_torch.core.engine import (McSASEngine,  # noqa: E402
                                         state_from_numpy)
from mcsas_tpu_torch.io import load_raw  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.ops import mc_kernel  # noqa: E402
from mcsas_tpu_torch.parallel import (Mesh, ShardedEnsemble,  # noqa: E402
                                      make_mesh, q_slices, rep_slices)
from mcsas_tpu_torch.tools import suite  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_engine as tte  # noqa: E402

CPU = [torch.device("cpu")] * 8
RESULT_FIELDS = ("contribs", "conval", "n_iter", "n_moves", "attempts",
                 "converged", "scaling", "background", "measval")


def cpu_mesh(shape):
    return make_mesh(shape, CPU)


@pytest.fixture(scope="module")
def sphere(refdata):
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    cfg = McSASConfig(num_contribs=30, num_reps=4, max_iterations=1000,
                      chunk_steps=500, seed=5, max_retries=0,
                      candidates_per_step=2)
    return d, get_model("Sphere").bind(), cfg


@pytest.fixture(scope="module")
def baseline(sphere):
    d, bound, cfg = sphere
    return McSASEngine(d, bound, cfg, device="cpu").run()


def assert_bitwise(res, base):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(res, f), getattr(base, f),
                                      err_msg=f)
    assert res.total_iters == base.total_iters
    assert res.w_ref == base.w_ref


def assert_contribs_match(res, base):
    """The JAX package's near-tie rule (tests/test_sharding.py:39-60):
    exact contributions, or every repetition but one bitwise equal and
    the sorted χ² within 2e-2 — a χ² comparison on a float32 rounding
    boundary may flip one accept under another float64 summation order
    and cascade within its repetition."""
    if np.array_equal(res.contribs, base.contribs):
        np.testing.assert_allclose(res.conval, base.conval, rtol=1e-5)
        return
    rep_equal = np.array([np.array_equal(a, b) for a, b in
                          zip(res.contribs, base.contribs)])
    assert rep_equal.sum() >= max(1, len(rep_equal) - 1), (
        "sharded contributions diverged in more than one repetition: "
        "not a borderline-tie cascade")
    np.testing.assert_allclose(np.sort(res.conval),
                               np.sort(base.conval), rtol=2e-2)


# ------------------------------------------------------------ the mesh

def test_mesh_slices_split_unevenly():
    mesh = cpu_mesh((4, 2))
    assert mesh.shape == (4, 2) and mesh.device(3, 1) == torch.device("cpu")
    assert rep_slices(3, mesh) == [slice(0, 1), slice(1, 2), slice(2, 3),
                                   slice(3, 3)]
    assert rep_slices(10, cpu_mesh((3, 1))) == [slice(0, 4), slice(4, 7),
                                                slice(7, 10)]
    assert q_slices(101, mesh) == [slice(0, 51), slice(51, 101)]
    for n, parts in ((10, 3), (3, 4), (100, 8)):
        want = [len(t) for t in torch.tensor_split(torch.arange(n), parts)]
        got = [s.stop - s.start for s in
               rep_slices(n, cpu_mesh((parts, 1)))]
        assert got == want
    assert hash(cpu_mesh((2, 1))) == hash(Mesh((2, 1), CPU[:2]))
    assert cpu_mesh((2, 1)) != cpu_mesh((1, 2))


def test_mesh_too_big_raises():
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh((16, 1), CPU)
    with pytest.raises(ValueError):
        Mesh((2, 2), CPU[:3])


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh((1, 1))


# ----------------------------------------- the rep axis, bit for bit

@pytest.mark.parametrize("shape", [(4, 1), (2, 1)])
def test_rep_sharded_matches_unsharded(sphere, baseline, shape):
    d, bound, cfg = sphere
    se = ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh(shape))
    assert [sh.n_reps for sh in se.shards] == [4 // shape[0]] * shape[0]
    assert_bitwise(se.run(), baseline)


def test_uneven_reps_match_unsharded(sphere):
    """3 repetitions on 4 shards: the last shard has none and runs
    nothing; the JAX package pads a fourth repetition instead."""
    d, bound, cfg = sphere
    cfg = cfg.replace(num_reps=3)
    se = ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh((4, 1)))
    assert [sh.n_reps for sh in se.shards] == [1, 1, 1, 0]
    res = se.run()
    assert res.contribs.shape == (3, 30, 1) and res.conval.shape == (3,)
    assert_bitwise(res, McSASEngine(d, bound, cfg, device="cpu").run())


def test_rep_sharded_local_moves_and_retries(sphere):
    """Local moves (the slot's own value in each candidate) and a retry
    budget: the retry batch is drawn whole and sliced, as the first."""
    d, bound, cfg = sphere
    cfg = cfg.replace(candidates_per_step=4, local_moves=0.5,
                      max_iterations=400, chunk_steps=100, max_retries=1)
    base = McSASEngine(d, bound, cfg, device="cpu").run()
    assert (base.attempts > 1).any()
    res = ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh((3, 1))).run()
    assert_bitwise(res, base)


def _cylinder_setup(refdata, monkeypatch, cap="64"):
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", cap)
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    bound = get_model("CylindersIsotropic").bind(
        active=("radius",), active_ranges={"radius": (1e-10, 5e-8)},
        fixed={"useAspect": 1.0, "aspect": 10.0})
    cfg = McSASConfig(num_reps=4, num_contribs=30,
                      convergence_criterion=2.0, max_iterations=3000,
                      chunk_steps=64, candidates_per_step=4, seed=7,
                      max_retries=0, table_ff="on", local_moves=0.5)
    return d, bound, cfg


def test_rep_sharded_table_tier(refdata, monkeypatch):
    """The table tier: the parent's segment length, the whole segment's
    proposals drawn once and sliced by repetition."""
    d, bound, cfg = _cylinder_setup(refdata, monkeypatch)
    base_eng = McSASEngine(d, bound, cfg, device="cpu")
    assert base_eng.uses_table and base_eng.prefetch_entry == "table"
    base = base_eng.run()
    se = ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh((2, 1)))
    assert se.uses_table and se.seg_steps == base_eng.seg_steps
    assert_bitwise(se.run(), base)


def test_rep_sharded_smeared_table(monkeypatch):
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
    d = suite.cylinder_smeared_golden()
    bound = suite.cylinder_bound()
    cfg = McSASConfig(num_contribs=10, num_reps=3, max_iterations=200,
                      chunk_steps=100, seed=5, max_retries=0,
                      candidates_per_step=2, table_ff="on",
                      show_incomplete=True)
    base_eng = McSASEngine(d, bound, cfg, device="cpu")
    assert base_eng.uses_table and base_eng.kern.table_is_intensity
    se = ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh((2, 1)))
    assert_bitwise(se.run(), base_eng.run())


# ------------------------------------------- the q axis, near-tie rule

@pytest.mark.parametrize("shape", [(1, 2), (4, 2), (1, 8)])
def test_q_sharded_matches_unsharded(sphere, baseline, shape):
    d, bound, cfg = sphere
    se = ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh(shape))
    assert [len(sh.devices) for sh in se.shards] == [shape[1]] * shape[0]
    res = se.run()
    assert_contribs_match(res, baseline)
    assert res.measval.shape == baseline.measval.shape


def test_q_sharded_table_tier(refdata, monkeypatch):
    d, bound, cfg = _cylinder_setup(refdata, monkeypatch)
    se = ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh((2, 4)))
    assert se.uses_table and not se.runs_cuda_kernel
    widths = [k.table.values.shape[1] for k in se.shards[0].kerns]
    assert widths == [s.stop - s.start for s in q_slices(d.count,
                                                         se.mesh)]
    assert_contribs_match(se.run(),
                          McSASEngine(d, bound, cfg, device="cpu").run())


def test_q_sharded_worm_tables(refdata, monkeypatch):
    """The worm's unsmeared table lies on the fit grid: each q shard takes
    its columns and its lookup's cross-section moves to the shard's points
    (``lookup.on_grid``).  Its smeared table lies on the flattened locs:
    under a q split the engine takes the model's own rule instead, the
    JAX package's ``table_grid_width_only`` decision."""
    from mcsas_tpu import data as jax_data
    from mcsas_tpu.config import McSASConfig as JaxConfig
    from mcsas_tpu.core.engine import make_intensity_kernels
    from mcsas_tpu.models import get_model as jax_get_model

    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "32")
    path = refdata / "sasfit_kho-1-10-1000.dat"
    d = data.load(path)
    bound = get_model("Kholodenko").bind()
    cfg = McSASConfig(num_reps=2, num_contribs=16,
                      convergence_criterion=2.0, max_iterations=600,
                      chunk_steps=100, candidates_per_step=2, seed=11,
                      max_retries=0, table_ff="on", show_incomplete=True)
    se = ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh((2, 4)))
    assert se.uses_table
    kern = se.shards[0].kerns[1]
    assert kern.table_fn.row_factor == ("cross_section", "radius")
    assert_contribs_match(se.run(),
                          McSASEngine(d, bound, cfg, device="cpu").run())

    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
    sm = dict(do_smear=True, n_steps=5, umbra=0.05e9, penumbra=0.2e9)
    raw = load_raw(path)[0][::12]
    d = data.from_raw(raw, config=data.DataConfig(
        n_bin=0, smearing=data.TrapezoidSmearing(**sm)))
    jd = jax_data.from_raw(raw, config=jax_data.DataConfig(
        n_bin=0, smearing=jax_data.TrapezoidSmearing(**sm)))
    cfg = cfg.replace(num_contribs=10, max_iterations=200, chunk_steps=20)
    jcfg = JaxConfig(num_reps=2, num_contribs=10, table_ff="on")
    jbound = jax_get_model("Kholodenko").bind()
    for q_axis in (1, 2):
        se = ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh((2, q_axis)))
        j_used = make_intensity_kernels(
            jbound, jd, jcfg, jnp.float32,
            table_grid_width_only=q_axis > 1)[3]
        assert se.uses_table == j_used == (q_axis == 1)
    # the q shards' rows are then the columns of the model's own rule
    kern = se.shards[0].kerns[1]
    assert kern.table is None and kern.locs.shape[0] == kern.grid.numel()
    pvec = torch.as_tensor(np.asarray([np.sqrt(lo * hi)
                                       for lo, hi in bound.ranges]),
                           dtype=torch.float32)
    np.testing.assert_allclose(kern.row(pvec).numpy(),
                               se.kern.row(pvec).numpy()[kern_cols(se)])


def kern_cols(se, j=1):
    """The fit-grid points of q shard *j* of *se*'s mesh."""
    return q_slices(se.consts.n, se.mesh)[j]


def test_q_sharded_solve_matches_jax_psum():
    """fitcore.solve_scale_bg on a list of q shards against the JAX
    package's solve under shard_map with its psum over a 2-device CPU
    mesh, on the same numpy inputs: the float64 sums to 1e-12 relative,
    scale, background and χ² equal as float32."""
    devs = jax.devices("cpu")
    if len(devs) < 2:
        pytest.skip("needs 2 virtual cpu devices")
    rs = np.random.default_rng(3)
    nq, r, k = 100, 4, 16
    x = rs.uniform(0.1, 3.0, (r, k, nq)).astype(np.float32)
    y = rs.uniform(1.0, 2.0, nq)
    fu = rs.uniform(0.01, 0.1, nq)
    c = fitcore.make_constants(y, fu)
    mesh = cpu_mesh((1, 2))
    cs = [fitcore.FitConstants(y=c.y[s], u=c.u[s], s_u=c.s_u, s_uy=c.s_uy,
                               n=c.n) for s in q_slices(nq, mesh)]
    xs = [torch.as_tensor(x[..., s]) for s in q_slices(nq, mesh)]
    # the same Σu and Σu·y (the JAX package sums them in float32)
    jc = jax_fitcore.make_constants(y, fu, jnp.float32)._replace(
        s_u=jnp.float32(c.s_u), s_uy=jnp.float32(c.s_uy))
    jmesh = JaxMesh(np.array(devs[:2]).reshape(1, 2), ("rep", "q"))
    in_specs = (P(None, None, "q"), P("q"), P("q"))

    def sums(xv, yv, uv):
        f64 = jnp.float64
        return tuple(jax.lax.psum(jnp.sum(v.astype(f64), axis=-1), "q")
                     for v in (uv * xv, uv * xv * xv, uv * xv * yv))

    j_sums = jax.jit(jax.shard_map(
        sums, mesh=jmesh, in_specs=in_specs, out_specs=P()))(
            jnp.asarray(x), jc.y, jc.u)
    for ours, theirs in zip(fitcore.moments(xs, cs), j_sums):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-12)
    for fb, pb in ((True, False), (True, True), (False, False)):
        def solve(xv, yv, uv, fb=fb, pb=pb):
            # the JAX solve takes one row: map it over (R, K)
            def one(row):
                sol = jax_fitcore.solve_scale_bg(
                    row, jc._replace(y=yv, u=uv), fb, pb, axis_name="q")
                return sol.scale, sol.background, sol.chisqr
            return jax.vmap(jax.vmap(one))(xv)
        j_sol = jax.jit(jax.shard_map(
            solve, mesh=jmesh, in_specs=in_specs, out_specs=P()))(
                jnp.asarray(x), jc.y, jc.u)
        ours = fitcore.solve_scale_bg(xs, cs, fb, pb)
        for got, want in zip((ours.scale, ours.background), j_sol):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # χ²: XLA's residual pass rounds 1 float32 ulp away from
        # PyTorch's and numpy's in a few candidates even unsharded; the
        # port's equals numpy's of the same scale and background
        a, b = ours.scale.numpy(), ours.background.numpy()
        u, yy = c.u.numpy(), c.y.numpy()
        r = (yy - a[..., None] * x) - b[..., None]
        chi = ((u * r * r).astype(np.float64).sum(-1) / nq)
        np.testing.assert_array_equal(ours.chisqr.numpy(),
                                      chi.astype(np.float32))
        j_chi = np.asarray(j_sol[2])
        assert np.all(np.abs(ours.chisqr.numpy() - j_chi)
                      <= np.spacing(np.abs(j_chi)))
        whole = fitcore.solve_scale_bg(torch.as_tensor(x), c, fb, pb)
        np.testing.assert_allclose(ours.chisqr.numpy(),
                                   whole.chisqr.numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", ["k4-global", "k8-local"])
def test_q_sharded_chunk_matches_jax_scan(refdata, name):
    """The plain chunk on two q shards, on the JAX proposals of
    ``chunk_pair`` (tests/test_torch_engine.py), against JAX's scan with
    the first-flip rule of ``test_chunk_twin_matches_jax_scan``."""
    mesh = cpu_mesh((1, 2))
    engines = {}

    def q_run(te, start, props, trace, steps=None):
        se = engines.setdefault("se", ShardedEnsemble(
            te.data, te.bound, te.cfg, mesh=mesh))
        sh = se.shards[0]
        states = se.shard_state(state_from_numpy(start))
        p = torch.tensor(props if steps is None else props[:steps])
        _, ri = mc_kernel.chunk_reference(
            states[0], 0, list(sh.consts), list(sh.specs), p, trace=trace)
        return se.whole_state(states), ri

    run = tte.make_chunk_pair(name, refdata, run=q_run)
    te = run["te"]
    flip = tte._first_flip(run)
    if flip is None:
        tte._assert_states_match(run["t_final"], run["j_final"],
                                 run["t_ri"], run["j_ri"], te.consts,
                                 run["ft_drift"])
        return
    s, r = flip
    tr = run["trace"]
    margin = float(mc_kernel.decision_margin(tr["chi"][s, r],
                                             tr["conval"][s, r]))
    assert margin <= tte.NEAR_TIE, f"first flip at step {s}, rep {r}"
    assert s > 0
    upto, ri = q_run(te, run["start"], run["props"], None, steps=s)
    tte._assert_states_match(tte.state_to_numpy(upto),
                             tte._jax_state_numpy(run["j_steps"][s - 1]),
                             ri, s % tte.N, te.consts, run["ft_drift"])


def test_q_shard_needs_a_lookup_that_moves(refdata, monkeypatch):
    """A lookup that neither only blends nor declares ``on_grid`` cannot
    give a q shard its columns: the engine raises instead of evaluating
    it elsewhere; on one device and the whole grid it runs as ever."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    bound = suite.unblendable_cylinder("opaque-lookup")
    cfg = McSASConfig(num_contribs=10, num_reps=2, max_iterations=40,
                      chunk_steps=20, table_ff="on", max_retries=0,
                      show_incomplete=True)
    with pytest.raises(ValueError, match="cannot move to a shard"):
        ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh((1, 2)))
    se = ShardedEnsemble(d, bound, cfg, mesh=cpu_mesh((2, 1)))
    assert se.shards[1].kerns[0] is se.kern
    assert np.isfinite(se.run().conval).all()


def test_q_axis_refuses_the_kernels(sphere):
    """Neither kernel sums across q shards: use_pallas='on' raises naming
    the q axis (on the card so does 'auto'); 'off' and the CPU's 'auto'
    run the plain chunk."""
    d, bound, cfg = sphere
    with pytest.raises(ValueError, match="shards the q axis"):
        ShardedEnsemble(d, bound, cfg.replace(use_pallas="on"),
                        mesh=cpu_mesh((1, 2)))
    se = ShardedEnsemble(d, bound, cfg.replace(use_pallas="off"),
                         mesh=cpu_mesh((1, 2)))
    assert not se.runs_cuda_kernel


def test_philox_stream_of_a_rep_shard(sphere):
    """K1 keys its Philox stream by (seed, rep_base + r): the host model
    of a shard's stream is the whole ensemble's, sliced."""
    d, bound, cfg = sphere
    spec = McSASEngine(d, bound, cfg, device="cpu").spec
    whole = mc_kernel.philox_proposals(spec, 77, 4, 20)
    part = mc_kernel.philox_proposals(spec, 77, 2, 20, rep_base=2)
    np.testing.assert_array_equal(part, whole[:, 2:])
    names = [f[0] for f in mc_kernel._ChunkParams._fields_]
    assert names.index("rep_base") == names.index("device") + 1


# ------------------------------------------------- fit, cache and CLI

def test_fit_on_a_mesh(refdata, sphere, monkeypatch):
    d, bound, cfg = sphere
    api._ENGINE_CACHE.clear()
    built = []

    class Counting(ShardedEnsemble):
        def __init__(self, *a, **kw):
            built.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(api, "ShardedEnsemble", Counting)
    mesh = cpu_mesh((2, 1))
    path = refdata / "sasfit_sphere-10-1.dat"
    res = api.fit(path, bound, cfg, mesh=mesh)
    again = api.fit(path, bound, cfg, mesh=mesh, device="cpu")
    assert len(built) == 1
    base = api.fit(path, bound, cfg, device="cpu")
    assert_bitwise(res.engine, base.engine)
    assert_bitwise(again.engine, base.engine)
    np.testing.assert_array_equal(res.fractions.measval,
                                  base.fractions.measval)
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        api.fit(path, bound, cfg, mesh=mesh, device="cuda")
    api._ENGINE_CACHE.clear()


def _cli_env():
    env = dict(os.environ)
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("mesh_arg", ["2", "x", "1,0", "1,2,3"])
def test_cli_bad_mesh_exits_2(refdata, tmp_path, capsys, mesh_arg):
    rc = cli.main([str(refdata / "sasfit_sphere-10-1.dat"), "-o",
                   str(tmp_path), "--device", "cpu", "--mesh", mesh_arg,
                   "--contribs", "10", "--reps", "1", "--max-iter", "50"])
    assert rc == 2
    assert "bad --mesh" in capsys.readouterr().err


def test_cli_mesh_runs(refdata, tmp_path):
    rc = cli.main([str(refdata / "sasfit_sphere-10-1.dat"), "-o",
                   str(tmp_path), "--device", "cpu", "--mesh", "1,1",
                   "--contribs", "10", "--reps", "2", "--max-iter", "300",
                   "--candidates", "2", "-l"])
    assert rc in (0, 1)
    assert list(tmp_path.rglob("*_fit.dat"))


def test_parallel_imports_no_jax(tmp_path):
    code = ("import sys\n"
            "import mcsas_tpu_torch.parallel, mcsas_tpu_torch.io.native\n"
            "import mcsas_tpu_torch.utils.profiling\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mcsas_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=_cli_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
