"""The cell ``core-shell-series`` on the CPU at a test's size: its frames,
the check that decides ``correct`` (the program passes, the control fails,
and so does each fault of ``test_portbench_correct.py``), and the reader
of ``k1cs_roofline``.  On the card ``test_portbench_cuda.py`` runs the cell
at its own size: it reads its cells from ``BENCHMARK.json``."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny
from benchmark import opmodel, run
from benchmark.reference import models, prep
from test_portbench_correct import _altered, _half_the_points, _unchanged

CELL = "core-shell-series"
TRAFFIC = json.loads((ROOT / "benchmark/traffic/core-shell-series.json")
                     .read_text())
CONFIG = json.loads((ROOT / "benchmark/configs/core-shell-sphere-k1.json")
                    .read_text())
FrameSource = run.generator(TRAFFIC["generator"])


def _small(**kw):
    return {**TRAFFIC, "basis_nodes": 64, "strata": 8, **kw}


def test_core_shell_frames_are_deterministic_and_follow_the_basis():
    a = FrameSource(_small(), 2 ** 31 + 77)
    b = FrameSource(_small(), 2 ** 31 + 77)
    c = FrameSource(_small(), 5)
    for i in (-2, -1, 0, 3, 7, 8, 21):
        assert np.array_equal(a.frame(i), b.frame(i))
        assert a.fit_seed(i) == b.fit_seed(i)
    # another seed: the same set of fits, in another order
    assert (sorted((a.stratum(i), a.fit_seed(i)) for i in range(16))
            == sorted((c.stratum(i), c.fit_seed(i)) for i in range(16)))
    # csmix.dat's own grid
    csmix = np.loadtxt(ROOT / "testdata/csmix.dat")[:, 0]
    assert np.allclose(a.q_nm, csmix, rtol=1e-9, atol=0)
    # a basis row is the reference's F²·v² at its core radius
    model = models.get("SphericalCoreShell")
    j = 17
    p = {**model.DEFAULTS, **TRAFFIC["fixed"], "radius": float(a.radii[j])}
    f = model.ff(torch.as_tensor(a.q_nm * prep.Q_TO_SI), p).numpy()
    want = f * f * model.volume(p) ** 2
    assert np.allclose(a.basis[j], want, rtol=1e-12, atol=0)
    # a frame is the normalized Gaussian sum of the rows, σ 1 % of I
    i = 3
    k = a.stratum(i)
    mu, s = a.means[k] * 1e-9, a.widths[k] * a.means[k] * 1e-9
    n = np.exp(-0.5 * ((a.radii - mu) / s) ** 2) * np.gradient(a.radii)
    i_q = n @ a.basis
    raw = a.frame(i)
    assert raw.shape == (180, 3) and raw[:, 1].max() == 1.0
    assert np.allclose(raw[:, 1], i_q / i_q.max(), rtol=1e-12)
    assert np.allclose(raw[:, 2], 0.01 * raw[:, 1], rtol=0, atol=0)


def test_frames_lie_four_widths_inside_the_active_ranges():
    """Every stratum's core radius ± 4 widths, and the fixed shell, lie
    inside the configuration's active ranges, so that a correct program
    can fit every frame to χ² ≤ 1."""
    src = FrameSource(_small(strata=TRAFFIC["strata"]), 1)
    (r_lo, r_hi), (t_lo, t_hi) = (CONFIG["activeRanges"][k]
                                  for k in ("radius", "t"))
    lo = src.means * (1.0 - 4.0 * src.widths) * 1e-9
    hi = src.means * (1.0 + 4.0 * src.widths) * 1e-9
    assert lo.min() > r_lo and hi.max() < r_hi
    assert t_lo < TRAFFIC["fixed"]["t"] < t_hi
    assert CONFIG["maxRetries"] == 5 and CONFIG["reduced"] == [
        "maxIterations"]


def _run(seed, **kw):
    """A run of the cell at a test's size, its frames rebinned to 40
    points and 32 candidates a step, so that a CPU fit takes a second."""
    piece = tiny(run.load_cell(CELL))
    piece["config"].update(candidatesPerStep=32, chunkSteps=100)
    piece["traffic"].update(basis_nodes=64)
    piece["traffic"]["data"] = {**piece["traffic"]["data"], "n_bin": 40}
    rec = run.run_cell(piece, seed, 1.0, device="cpu", **kw)
    return piece, rec


def test_program_passes_and_control_fails():
    piece, rec = _run(2 ** 31 + 21, control=True)
    assert rec["shape"]["model"] == "SphericalCoreShell"
    assert rec["shape"]["params"] == 2
    assert run.passes(rec["checks"], piece["limits"]), rec["checks"]
    assert not run.passes(rec["control"], piece["limits"]), rec["control"]


@pytest.mark.parametrize("fault", [_unchanged, _half_the_points, _altered],
                         ids=["state_unchanged", "half_the_points",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    piece, rec = _run(2 ** 31 + 22)
    assert not run.passes(rec["checks"], piece["limits"]), rec["checks"]


CS_SHAPE = {"model": "SphericalCoreShell", "nq": 100, "reps": 10,
            "contribs": 300, "params": 2, "table_values": 0,
            "table_axes": 0, "intensity_table": False,
            "cross_section": False}


def test_k1cs_roofline_reads_the_op_model():
    assert run.work_shape(CONFIG, TRAFFIC, 100) == CS_SHAPE
    read = run.reader("k1cs_roofline")
    chunk = 2048 * 10 * 128
    rec = {"shape": CS_SHAPE,
           "fits": [{"total_iters": 3 * chunk}, {"total_iters": 10 ** 9}],
           "device": {"kernels_by_tag": {"mc_chunk": (0.05, 3)},
                      "fits": 1}}
    # per point: the core-shell row 25 and the solve 14
    assert opmodel.k1_proposal_ops(CS_SHAPE) == 100 * (25 + 14)
    bound = opmodel.bound_s(3 * opmodel.k1_launch_bytes(CS_SHAPE),
                            3 * chunk * opmodel.k1_proposal_ops(CS_SHAPE))
    assert read(rec) == pytest.approx(100.0 * bound / 0.05, rel=1e-12)
    assert 0.0 < read(rec) < 1.0
    assert read(rec) == run.reader("k1_roofline")(rec)
    # no K1 time in the trace, no trace, or another model
    assert read({**rec, "device": {"kernels_by_tag": {}, "fits": 1}}) is None
    assert read({"shape": CS_SHAPE, "fits": rec["fits"]}) is None
    assert read({**rec, "shape": {**CS_SHAPE, "model": "Sphere"}}) is None


def test_the_cell_reports_its_metrics():
    piece = run.load_cell(CELL)
    assert piece["cell"]["chips"] == 1
    assert [m["name"] for m, _ in piece["end_to_end"]] == ["fits_per_s",
                                                           "setup_s"]
    layer = [m["name"] for m, _ in piece["per_layer"]]
    assert "k1cs_roofline" in layer and "k1_roofline" not in layer
    assert {"api.setup_ms", "engine.run_ms", "post.ms",
            "device.idle_pct"} <= set(layer)
    assert set(piece["limits"]) == {"chi2_gap", "scale_gap", "bg_gap",
                                    "post_gap", "failed_share"}
    assert piece["limits"]["failed_share"] == 0.3
    # no other cell reads the new share
    for other in ("sphere-series", "cylinder-series", "worm-series",
                  "cylinder-slit-series"):
        assert "k1cs_roofline" not in [
            m["name"] for m, _ in run.load_cell(other)["per_layer"]]


def test_the_core_shell_reference_imports_nothing_of_the_program():
    code = ("import sys, torch\n"
            "from benchmark.reference import models\n"
            "m = models.get('SphericalCoreShell')\n"
            "q = torch.logspace(7, 10, 20, dtype=torch.float64)\n"
            "m.ff(q, {**m.DEFAULTS, 't': 2e-9,"
            " 'radius': torch.tensor([[3e-9], [6e-9]])})\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = set(eval(p.stdout.splitlines()[-1]))
    assert "mcsas_tpu_torch" not in mods and not mods & set(run.FORBIDDEN)
