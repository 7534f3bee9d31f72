# -*- coding: utf-8 -*-
"""PyTorch port, the core-shell sphere against the benchmark's plain
float64 reference (``benchmark/reference/models/SphericalCoreShell.py``,
nothing of the port): the form factor and volume across the Rayleigh
series' switch, a small seeded fit on a frame of the cell
``core-shell-series`` judged as the harness judges the card's fits, and
the engine's counters of retried and unconverged repetitions."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import run  # noqa: E402
from benchmark.reference import core, models, prep  # noqa: E402
from mcsas_tpu_torch import api  # noqa: E402
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.data import from_raw  # noqa: E402
from mcsas_tpu_torch.models import ellipsoids, get_model  # noqa: E402
from mcsas_tpu_torch.utils.profiling import recording  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = models.get("SphericalCoreShell")
CELL = "core-shell-series"
CONFIG = json.loads((ROOT / "benchmark/configs/core-shell-sphere-k1.json")
                    .read_text())


def _draw(n, seed):
    """*n* (radius, t) pairs, log-uniform over the config's active
    ranges."""
    rng = np.random.default_rng(seed)
    cols = [np.exp(rng.uniform(np.log(lo), np.log(hi), n))
            for lo, hi in (CONFIG["activeRanges"][k] for k in ("radius",
                                                               "t"))]
    return np.stack(cols, axis=-1)


def _params(vals, extra=None):
    v = torch.as_tensor(vals)
    p = {**REF.DEFAULTS, **CONFIG["fixed"], **(extra or {})}
    p["radius"], p["t"] = v[..., 0:1], v[..., 1:2]
    return p


def test_form_factor_and_volume_agree_with_the_reference():
    """``_sph_cs_ff`` against the reference on q·R from 1e-5 to 200 for
    each of 16 drawn (R, t), across both series switches (the port's at
    0.05, the reference's at 1e-3), within 1e-9 of the terms' scale
    |η_s − η_sol| + (v_c/v_t)·|η_s − η_c|: the closed form's rounding
    just above the reference's switch is eps/x² ≈ 2e-10 of it.  The
    volume (and the absolute volume, which is the volume) within 1e-15
    relative."""
    vals = _draw(16, 27)
    x = np.geomspace(1e-5, 200.0, 801)
    q = torch.as_tensor(x[None, :] / vals[:, :1])           # (16, 801)
    p = _params(vals)
    pd = get_model("SphericalCoreShell").bind(
        active=("radius", "t")).pdict(torch.as_tensor(vals[:, None]))
    ours = ellipsoids._sph_cs_ff(q, pd).numpy()
    want = REF.ff(q, p).numpy()
    ratio = (vals[:, 0] / vals.sum(1)) ** 3
    scale = (abs(p["eta_s"] - p["eta_sol"])
             + ratio * abs(p["eta_s"] - p["eta_c"]))
    assert np.all(np.abs(ours - want) <= 1e-9 * scale[:, None])
    # the small-x limit is the contrast-weighted volume ratio
    lim = (p["eta_s"] - p["eta_sol"]) - ratio * (p["eta_s"] - p["eta_c"])
    assert np.allclose(want[:, 0], lim, rtol=1e-9, atol=0)
    bound = get_model("SphericalCoreShell").bind(active=("radius", "t"))
    v = torch.as_tensor(vals)
    for fn in (bound.volume, bound.absvolume):
        got = fn(v).numpy().reshape(-1)
        ref = REF.volume({"radius": v[:, 0], "t": v[:, 1]}).numpy()
        assert np.allclose(got, ref, rtol=1e-15, atol=0)
    assert REF.absvolume({"radius": 2e-9, "t": 1e-9}) == REF.volume(
        {"radius": 2e-9, "t": 1e-9})


def test_a_small_fit_of_a_cell_frame_passes_the_harness_check():
    """50 contributions × 2 repetitions on frame 0 of the cell's generator
    (a coarse basis, the frame rebinned to 40 points), on the CPU:
    converged, and the harness's gaps against the reference (MC χ²,
    scaling and background, the post pass) within the cell's limits; the
    reference in bfloat16 in the program's place fails them."""
    piece = run.load_cell(CELL)
    traffic = dict(piece["traffic"], basis_nodes=128, strata=8)
    traffic["data"] = dict(traffic["data"], n_bin=40)
    config = dict(piece["config"], numContribs=50, numReps=2,
                  candidatesPerStep=32, chunkSteps=100,
                  maxIterations=2_000_000)
    _, bound, base, data_cfg = run.program_setup(config, traffic)
    src = piece["generator"](traffic, 2 ** 31 + 27, "cpu")
    raw = src.frame(0)
    res = api.fit(from_raw(raw, config=data_cfg), bound,
                  base.replace(seed=src.fit_seed(0)), device="cpu")
    assert res.engine.converged.all() and not res.engine.used_pallas
    fg = prep.derive(raw, traffic["data"])
    assert len(fg["q"]) == 40
    out = run.outputs(res)
    judged = out["engine"]["conval"] <= config["convergenceCriterion"]
    ref = core.reference(config, fg, out["contribs"], core.exact)
    gaps = core.judge(out, ref, fg, judged)
    limits = {k: v for k, v in piece["limits"].items()
              if k != "failed_share"}
    assert run.passes(gaps, limits), gaps
    low = core.reference(config, fg, out["contribs"], core.bfloat16)
    assert not run.passes(core.judge(low, ref, fg, judged), limits)


def _engine(max_retries, criterion):
    """A one-repetition core-shell engine on a frame of the cell, on the
    CPU, 600 proposals an attempt."""
    piece = run.load_cell(CELL)
    traffic = dict(piece["traffic"], basis_nodes=64, strata=8)
    traffic["data"] = dict(traffic["data"], n_bin=40)
    _, bound, _, data_cfg = run.program_setup(piece["config"], traffic)
    src = piece["generator"](traffic, 5, "cpu")
    cfg = McSASConfig(num_contribs=20, num_reps=1, max_iterations=600,
                      chunk_steps=50, candidates_per_step=4, seed=3,
                      max_retries=max_retries,
                      convergence_criterion=criterion)
    return McSASEngine(from_raw(src.frame(0), config=data_cfg), bound, cfg,
                       device="cpu")


def _fields(res):
    return {k: v for k, v in vars(res).items()
            if k not in ("elapsed", "iters_per_sec", "moves_per_sec")}


@pytest.mark.parametrize("case", ["gives_up", "converges"])
def test_retry_counters_record_under_recording_only(case):
    """One repetition that never reaches a criterion of 1e-12, with one
    retry allowed, is retried once (``core.engine.retried_reps``) and
    then left unconverged (``core.engine.unconverged_reps``); one that
    meets a criterion of 1e12 at its first read counts neither.  Outside
    ``recording()`` nothing is counted, and the result is the same bits
    with recording on and off."""
    retries, criterion = (0, 1e-12) if case == "gives_up" else (0, 1e12)
    with recording() as rec:
        on = _engine(retries, criterion).run()
    with recording() as idle:
        pass
    off = _engine(retries, criterion).run()
    counters = {k: v for k, v in rec.counters.items()
                if k.startswith("core.engine.") and k.endswith("_reps")}
    if case == "gives_up":
        assert counters == {"core.engine.retried_reps": 1,
                            "core.engine.unconverged_reps": 1}
        assert not on.converged.any() and on.attempts.tolist() == [2]
    else:
        assert counters == {} and on.converged.all()
        assert on.attempts.tolist() == [1]
    assert idle.counters == {}
    a, b = _fields(on), _fields(off)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
