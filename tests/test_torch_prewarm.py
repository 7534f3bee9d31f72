# -*- coding: utf-8 -*-
"""PyTorch port: ``prewarm`` and ``engine_cls`` (mcsas_tpu/api.py:222-286,
mcsas_tpu/core/engine.py:545-575 in the JAX package) on the CPU.  A fit
after a prewarm is the fit without one, bit for bit; ``fit`` prewarms a
cached engine once; ``run_files`` and the CLI take the flag.  The card's
prewarm (the kernel library's build and load, the kernel's attributes)
is rehearsed here with its kernel calls replaced by recorders, on a
CPU engine told that a kernel runs its chunks: what it calls, on which
shards, and that it leaves the engine's generator alone; on the card
``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 23 and this file's
``cuda`` test (the worm's prewarm, after which a fit builds nothing) run
it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import mcsas_tpu_torch as mt  # noqa: E402
from mcsas_tpu_torch import api  # noqa: E402
from mcsas_tpu_torch.cli import main as cli_main  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.ops import (bank_route, cuda_lib, kho_bank,  # noqa: E402
                                 mc_kernel)
from mcsas_tpu_torch.parallel import ShardedEnsemble, make_mesh  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402

_SPHERE = "sasfit_sphere-10-1.dat"
_TINY = dict(num_contribs=10, num_reps=2, max_iterations=200,
             chunk_steps=50, candidates_per_step=4, local_moves=0.5,
             max_retries=0, seed=3)


@pytest.fixture
def fresh_cache(monkeypatch):
    monkeypatch.setattr(api, "_ENGINE_CACHE", {})


@pytest.fixture
def small_table(monkeypatch):
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")


def _cylinder():
    """The cylinder row's data and binding on a 64-row table (4 segment
    steps a chunk)."""
    cfg = suite.cylinder_config(**dict(_TINY, table_ff="on",
                                       chunk_steps=4))
    return suite.cylinder_golden(), suite.cylinder_bound(), cfg


@pytest.mark.parametrize("model", ["Sphere", "CylindersIsotropic"])
def test_fit_after_prewarm_is_bitwise_the_fit(refdata, fresh_cache,
                                              small_table, model):
    """fit(prewarm=True) on a new engine equals fit() on another, bit for
    bit: contributions, χ², counters and the post pass."""
    if model == "Sphere":
        d, b, cfg = (mt.load(refdata / _SPHERE), "Sphere",
                     McSASConfig(**_TINY))
    else:
        d, b, cfg = _cylinder()
    plain = mt.fit(d, b, cfg, device="cpu")
    api._ENGINE_CACHE.clear()
    warm = mt.fit(d, b, cfg, device="cpu", prewarm=True)
    (eng,) = api._ENGINE_CACHE.values()
    assert eng._prewarm_done and eng.uses_table == (model != "Sphere")
    for f in ("contribs", "conval", "n_iter", "n_moves", "scaling",
              "background"):
        np.testing.assert_array_equal(getattr(warm.engine, f),
                                      getattr(plain.engine, f))
    np.testing.assert_array_equal(warm.fractions.measval,
                                  plain.fractions.measval)
    np.testing.assert_array_equal(warm.histograms[0].bins.mean,
                                  plain.histograms[0].bins.mean)


def test_prewarm_on_the_cpu_skips_as_data(refdata):
    """Without a kernel there is nothing to build or load: every label
    says why it was skipped, and nothing raises."""
    eng = McSASEngine(mt.load(refdata / _SPHERE), mt.get_model(
        "Sphere").bind(), McSASConfig(**_TINY), device="cpu")
    out = eng.prewarm()
    assert set(out) == {"nvcc mc_chunk", "load mc_chunk", "init",
                        "attributes mc_chunk"}
    assert all(v.startswith("skipped: the plain chunk runs this engine "
                            "on cpu") for v in out.values())


def test_fit_prewarms_a_cached_engine_once(refdata, fresh_cache,
                                          monkeypatch):
    """A second fit(prewarm=True) on the cached engine prewarms neither
    the engine nor the post pass again; fit(engine_cls=...) builds that
    class, and a new class is a new cache entry."""
    calls = []

    class Recording(McSASEngine):
        def prewarm(self):
            calls.append(("engine", self))
            return super().prewarm()

    post = api.prewarm_post

    def recording_post(*args, **kw):
        calls.append(("post", kw.get("device")))
        return post(*args, **kw)

    monkeypatch.setattr(api, "prewarm_post", recording_post)
    d, cfg = mt.load(refdata / _SPHERE), McSASConfig(**_TINY)
    first = mt.fit(d, "Sphere", cfg, device="cpu", prewarm=True,
                   engine_cls=Recording)
    second = mt.fit(d, "Sphere", cfg, device="cpu", prewarm=True,
                    engine_cls=Recording)
    (eng,) = api._ENGINE_CACHE.values()
    assert type(eng) is Recording
    assert calls == [("engine", eng), ("post", torch.device("cpu"))]
    np.testing.assert_array_equal(first.engine.contribs,
                                  second.engine.contribs)
    mt.fit(d, "Sphere", cfg, device="cpu")
    assert len(api._ENGINE_CACHE) == 2
    assert {type(e) for e in api._ENGINE_CACHE.values()} == {
        Recording, McSASEngine}


def test_prewarm_post_runs_the_post_pass_on_the_device(refdata,
                                                       monkeypatch):
    """prewarm_post runs histogram_all once on a dummy set of the fit's
    shape (each value its range's geometric mean) on the device asked
    for; a failing post pass raises."""
    seen = []

    def fake(contribs, data, bound, cfg, specs, device):
        seen.append((np.array(contribs), specs, device))
        raise FloatingPointError("post pass failed")

    monkeypatch.setattr(api, "histogram_all", fake)
    d = mt.load(refdata / _SPHERE)
    b = mt.get_model("Sphere").bind(active_ranges={"radius": (1e-9,
                                                               4e-9)})
    with pytest.raises(FloatingPointError, match="post pass failed"):
        api.prewarm_post(d, b, McSASConfig(**_TINY), device="cpu")
    (contribs, specs, device), = seen
    assert contribs.shape == (2, 10, 1) and specs is None
    assert device == "cpu" and contribs.flags.writeable
    np.testing.assert_allclose(contribs, 2e-9, rtol=1e-12)


# ---------------------------------------------- the card's path, rehearsed

@pytest.fixture
def recorded_kernel(monkeypatch):
    """The kernel libraries' build and load and the chunk kernels' shape
    calls replaced by recorders that answer as on the card;
    torch.cuda.synchronize a no-op."""
    calls = []

    def build(names):
        calls.append(("build", tuple(names)))
        return {n: cuda_lib.KernelBuild(path=None, seconds=0.0, log="")
                for n in names}

    def shape(kind):
        def fn(state, consts, spec, *args):
            calls.append((kind, state, args))
            return {"group": 8}
        return fn

    monkeypatch.setattr(cuda_lib, "build_libraries", build)
    monkeypatch.setattr(cuda_lib, "load",
                        lambda name: calls.append(("load", name)))
    monkeypatch.setattr(mc_kernel, "launch_shape", shape("k1"))
    monkeypatch.setattr(mc_kernel, "prefetch_launch_shape", shape("k2"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return calls


def _kernel_engine(eng):
    """*eng* with its chunks routed to a kernel, as on the card."""
    eng.runs_cuda_kernel = True
    return eng


def test_prewarm_builds_loads_and_queries_k1(refdata, recorded_kernel):
    """On the card's path the Sphere engine builds and loads mc_chunk
    once, queries K1's attributes on a state of the engine's shape, and
    leaves the generator as it was: the run after it equals a fresh
    engine's run bit for bit."""
    d, b = mt.load(refdata / _SPHERE), mt.get_model("Sphere").bind()
    cfg = McSASConfig(**_TINY)
    eng = _kernel_engine(McSASEngine(d, b, cfg, device="cpu"))
    eng.gen.manual_seed(77)
    gen_state = eng.gen.get_state().clone()
    out = eng.prewarm()
    assert torch.equal(eng.gen.get_state(), gen_state)
    assert list(out) == ["nvcc mc_chunk", "load mc_chunk", "init",
                         "attributes mc_chunk"]
    assert out["nvcc mc_chunk"] == 0.0
    assert all(isinstance(v, float) and v >= 0.0 for v in out.values())
    kinds = [c[0] for c in recorded_kernel]
    assert kinds == ["build", "load", "k1"]
    assert recorded_kernel[0][1] == ("mc_chunk",)
    assert recorded_kernel[1][1] == "mc_chunk"
    state = recorded_kernel[2][1]
    assert tuple(state.rset.shape) == (2, 10, 1)
    assert tuple(state.ibank.shape) == (2, 10, d.count)
    eng.runs_cuda_kernel = False
    after = eng.run()
    fresh = McSASEngine(d, b, cfg, device="cpu").run()
    np.testing.assert_array_equal(after.contribs, fresh.contribs)
    np.testing.assert_array_equal(after.conval, fresh.conval)


@pytest.mark.parametrize("entry", ["table", "rows", "plugin"])
def test_prewarm_queries_k2_with_a_segment(small_table, recorded_kernel,
                                           entry):
    """The table engine builds and loads mc_prefetch and queries K2's
    attributes on one segment's candidates (S, R, K, P) — with the
    segment's rows (S, R, K, Nq) where it runs the rows-in entry, as an
    elementwise plugin does (its rows from its own ff)."""
    d, b, cfg = _cylinder()
    if entry == "rows":
        b = suite.unblendable_cylinder("opaque-lookup")
    if entry == "plugin":
        b = dataclasses.replace(mt.get_model("Sphere"),
                                name="SpherePlugin").bind()
    eng = _kernel_engine(McSASEngine(d, b, cfg, device="cpu"))
    assert eng.prefetch_entry == ("rows" if entry == "plugin" else entry)
    out = eng.prewarm()
    assert list(out) == ["nvcc mc_prefetch", "load mc_prefetch", "init",
                         "attributes mc_prefetch"]
    (_, names), (_, lib), (kind, state, args) = recorded_kernel
    assert names == ("mc_prefetch",) and lib == "mc_prefetch"
    assert kind == "k2"
    cands = args[0]
    assert tuple(cands.shape) == (eng.seg_steps, 2, 4, 1)
    lo, hi = b.ranges[0]
    assert float(cands.min()) >= np.float32(lo)
    assert float(cands.max()) <= np.float32(hi)
    if entry != "table":
        assert tuple(args[1].shape) == (eng.seg_steps, 2, 4, d.count)
    else:
        assert len(args) == 1


def _worm():
    """The worm row's data (sasfit_kho-1-10-1000.dat rebinned to 100
    points) and binding on a table of at most the env's nodes an axis."""
    row = suite.TABLE_ROWS["kholodenko-worm"]
    d = row.load()
    return d, row.bound(d)


@pytest.mark.parametrize("bank,smear", [("cyl_bank", False),
                                        ("cyl_bank", True),
                                        ("kho_bank", False)])
def test_prewarm_builds_the_bank_kernel_beside_k2(small_table,
                                                  recorded_kernel,
                                                  monkeypatch, bank, smear):
    """Where the fit's post pass launches a bank kernel (the route
    answered as on the card: the cylinders' unsmeared and through the
    slit, the worm's), prewarm builds mc_prefetch and that kernel's
    library in one nvcc round and loads both before the init; an engine
    whose post pass keeps the eager bank (the Sphere) builds its chunk
    kernel's library alone."""
    route = bank_route.kernel_for
    monkeypatch.setattr(bank_route, "kernel_for",
                        lambda bound, data, device: route(bound, data,
                                                          "cuda"))
    if bank == "cyl_bank":
        d, b, cfg = _cylinder()
        if smear:
            d = suite.cylinder_smeared_golden()
    else:
        monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
        d, b = _worm()
        cfg = McSASConfig(**dict(_TINY, table_ff="on", chunk_steps=4))
    eng = _kernel_engine(McSASEngine(d, b, cfg, device="cpu"))
    assert eng.prefetch_entry == "table"
    assert list(eng.prewarm()) == ["nvcc mc_prefetch", f"nvcc {bank}",
                                   "load mc_prefetch", f"load {bank}",
                                   "init", "attributes mc_prefetch"]
    assert recorded_kernel[0] == ("build", ("mc_prefetch", bank))
    assert recorded_kernel[1:3] == [("load", "mc_prefetch"),
                                    ("load", bank)]
    del recorded_kernel[:]
    sphere = mt.get_model("Sphere").bind()
    eng = _kernel_engine(McSASEngine(d, sphere, McSASConfig(**_TINY),
                                     device="cpu"))
    assert list(eng.prewarm()) == ["nvcc mc_chunk", "load mc_chunk",
                                   "init", "attributes mc_chunk"]
    assert recorded_kernel[:2] == [("build", ("mc_chunk",)),
                                   ("load", "mc_chunk")]


@pytest.mark.cuda
def test_worm_prewarm_leaves_the_first_fit_nothing_to_build(monkeypatch):
    """On the card: fit(prewarm=True) of the worm builds and loads
    mc_prefetch and kho_bank in the engine's prewarm; after it the
    prewarm's post pass, the fit and the fit's post pass build and load
    no library, and each post pass is one kho_bank launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
    monkeypatch.setattr(api, "_ENGINE_CACHE", {})
    labels = []

    def refuse(*args):
        raise AssertionError(f"built or loaded after the prewarm: {args}")

    class Guarded(McSASEngine):
        def prewarm(self):
            out = super().prewarm()
            labels.extend(out)
            # a library the process has not loaded is built (or found
            # built) first: refusing the build refuses every new load
            monkeypatch.setattr(cuda_lib, "build_libraries", refuse)
            return out

    d, b = _worm()
    cfg = McSASConfig(num_contribs=40, num_reps=3, candidates_per_step=32,
                      local_moves=0.75, seed=6, max_iterations=200_000,
                      max_retries=0, table_ff="on", show_incomplete=True)
    before = kho_bank.run_kho_bank.launches
    # the loaded libraries forgotten: the prewarm loads them
    with cuda_lib.sources(cuda_lib.CSRC, cuda_lib.BUILD_DIR):
        res = mt.fit(d, b, cfg, device="cuda", prewarm=True,
                     engine_cls=Guarded)
    assert labels[:4] == ["nvcc mc_prefetch", "nvcc kho_bank",
                          "load mc_prefetch", "load kho_bank"]
    assert res.engine.used_prefetch
    assert kho_bank.run_kho_bank.launches == before + 2
    assert np.isfinite(res.fractions.measval).all()


def test_sharded_prewarm_queries_every_shard(refdata, recorded_kernel):
    """ShardedEnsemble.prewarm queries the kernel once per repetition
    shard, each on its own part of the state (3 + 2 repetitions)."""
    d, b = mt.load(refdata / _SPHERE), mt.get_model("Sphere").bind()
    cfg = McSASConfig(**dict(_TINY, num_reps=5))
    mesh = make_mesh((2, 1), [torch.device("cpu")] * 2)
    eng = _kernel_engine(ShardedEnsemble(d, b, cfg, mesh=mesh))
    eng.prewarm()
    shapes = [tuple(c[1].rset.shape) for c in recorded_kernel
              if c[0] == "k1"]
    assert shapes == [(3, 10, 1), (2, 10, 1)]


def test_prewarm_raises_when_the_build_fails(refdata, recorded_kernel,
                                             monkeypatch):
    """No fallback: a failed nvcc (or load) raises out of prewarm and out
    of fit(prewarm=True)."""
    def failing(names):
        raise RuntimeError("nvcc failed with exit code 1 building "
                           "csrc/mc_chunk.cu")

    monkeypatch.setattr(cuda_lib, "build_libraries", failing)
    d, b = mt.load(refdata / _SPHERE), mt.get_model("Sphere").bind()
    eng = _kernel_engine(McSASEngine(d, b, McSASConfig(**_TINY),
                                     device="cpu"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        eng.prewarm()


# ---------------------------------------------------- run_files and CLI

def test_run_files_and_cli_take_prewarm(refdata, tmp_path, fresh_cache):
    """run_files(prewarm=True) and ``--prewarm --device cpu`` run to an
    end: rc 0 and the fits converge."""
    cfg = McSASConfig(num_contribs=10, num_reps=1, max_iterations=100_000,
                      candidates_per_step=16, chunk_steps=500, seed=3)
    res = api.run_files([str(refdata / _SPHERE)], "Sphere", cfg,
                        out_dir=tmp_path / "files", device="cpu",
                        prewarm=True)
    assert res[0].converged
    assert all(e._prewarm_done for e in api._ENGINE_CACHE.values())
    rc = cli_main([str(refdata / _SPHERE), "-o", str(tmp_path / "cli"),
                   "--contribs", "10", "--reps", "1", "--max-iter",
                   "100000", "--candidates", "16", "--seed", "3",
                   "--nolog", "--device", "cpu", "--prewarm"])
    assert rc == 0
