"""The cell ``worm-series`` on the CPU at a test's size: its frames, the
check that decides ``correct`` (the program passes, the control fails,
and so does each fault of ``test_portbench_correct.py``, the step's fault
on the worm's own plain step), and the reader of ``k2xs_roofline``.
On the card ``test_portbench_cuda.py`` runs the cell at its own size: it
reads its cells from ``BENCHMARK.json``."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny
from benchmark import opmodel, run
from benchmark.reference import models, prep
from test_portbench_correct import _altered, _half_the_points

CELL = "worm-series"
TRAFFIC = json.loads((ROOT / "benchmark/traffic/worm-series.json")
                     .read_text())
FrameSource = run.generator(TRAFFIC["generator"])


def _small(**kw):
    return {**TRAFFIC, "basis_nodes": 64, "strata": 8, **kw}


def test_worm_frames_are_deterministic_and_follow_the_basis():
    a = FrameSource(_small(), 2 ** 31 + 77)
    b = FrameSource(_small(), 2 ** 31 + 77)
    c = FrameSource(_small(), 5)
    for i in (-2, -1, 0, 3, 7, 8, 21):
        assert np.array_equal(a.frame(i), b.frame(i))
        assert a.fit_seed(i) == b.fit_seed(i)
    # another seed: the same set of fits, in another order
    assert (sorted((a.stratum(i), a.fit_seed(i)) for i in range(16))
            == sorted((c.stratum(i), c.fit_seed(i)) for i in range(16)))
    assert np.allclose(a.q_nm, np.geomspace(0.01, 10.0, 501), rtol=1e-15)
    # a basis row is the reference's F²·v² at its contour length
    model = models.get("Kholodenko")
    j = 17
    p = {**model.DEFAULTS, **TRAFFIC["fixed"],
         "lenContour": float(a.radii[j])}
    f = model.ff(torch.as_tensor(a.q_nm * prep.Q_TO_SI), p).numpy()
    want = f * f * model.volume(p) ** 2
    assert np.allclose(a.basis[j], want, rtol=1e-12, atol=0)
    # a frame is the normalized Gaussian sum of the rows, σ 1 % of I
    i = 3
    k = a.stratum(i)
    mu, s = a.means[k] * 1e-9, a.widths[k] * a.means[k] * 1e-9
    r = a.radii
    if s > 0.0:
        n = np.exp(-0.5 * ((r - mu) / s) ** 2) * np.gradient(r)
    else:
        n = (np.arange(len(r)) == np.argmin(np.abs(r - mu))).astype(float)
    i_q = n @ a.basis
    raw = a.frame(i)
    assert raw.shape == (501, 3) and raw[:, 1].max() == 1.0
    assert np.allclose(raw[:, 1], i_q / i_q.max(), rtol=1e-12)
    assert np.allclose(raw[:, 2], 0.01 * raw[:, 1], rtol=0, atol=0)


def _run(seed, **kw):
    piece = tiny(run.load_cell(CELL))
    piece["traffic"].update(basis_nodes=64)
    rec = run.run_cell(piece, seed, 1.0, device="cpu", **kw)
    return piece, rec


def test_program_passes_and_control_fails():
    piece, rec = _run(2 ** 31 + 21, control=True)
    assert rec["shape"]["cross_section"] and rec["shape"]["table_axes"] == 2
    assert run.passes(rec["checks"], piece["limits"]), rec["checks"]
    assert not run.passes(rec["control"], piece["limits"]), rec["control"]


def _unchanged(monkeypatch):
    """The worm's step on the CPU (K2's plain version) returns its state
    unchanged."""
    from mcsas_tpu_torch.ops import mc_kernel
    monkeypatch.setattr(
        mc_kernel, "prefetch_reference",
        lambda state, ri, consts, spec, rows, cands, trace=None:
        (state, (ri + int(cands.shape[0])) % state.rset.shape[1]))


@pytest.mark.parametrize("fault", [_unchanged, _half_the_points, _altered],
                         ids=["state_unchanged", "half_the_points",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    piece, rec = _run(2 ** 31 + 22)
    assert not run.passes(rec["checks"], piece["limits"]), rec["checks"]


WORM_SHAPE = {"model": "Kholodenko", "nq": 100, "reps": 10,
              "contribs": 300, "params": 3, "table_values": 12288 * 100,
              "table_axes": 2, "intensity_table": False,
              "cross_section": True}


def test_k2xs_roofline_reads_the_op_model():
    config = json.loads((ROOT / "benchmark/configs/worm-k2xs.json")
                        .read_text())
    assert run.work_shape(config, TRAFFIC, 100) == WORM_SHAPE
    read = run.reader("k2xs_roofline")
    seg = 131 * 10 * 128
    rec = {"shape": WORM_SHAPE,
           "fits": [{"total_iters": 2 * seg}, {"total_iters": 10 ** 9}],
           "device": {"kernels_by_tag": {"mc_prefetch": (4.95e-3, 2)},
                      "fits": 1}}
    # per point: the solve 14, four corners, the clamp and the square 3,
    # the cross-section 23
    assert opmodel.k2_proposal_ops(WORM_SHAPE) == 100 * (14 + 4 + 3 + 23)
    bound = opmodel.bound_s(
        2 * opmodel.k2_launch_bytes(WORM_SHAPE)
        + 2 * seg * opmodel.k2_proposal_bytes(WORM_SHAPE),
        2 * seg * opmodel.k2_proposal_ops(WORM_SHAPE))
    assert read(rec) == pytest.approx(100.0 * bound / 4.95e-3, rel=1e-12)
    assert 0.0 < read(rec) < 1.0
    assert read(rec) == run.reader("k2_roofline")(rec)
    # no K2 time in the trace, no trace, or a table without the factor
    rec["device"]["kernels_by_tag"] = {"mc_chunk": (1.0, 3)}
    assert read(rec) is None
    assert read({"shape": WORM_SHAPE, "fits": rec["fits"]}) is None
    rec = {**rec, "shape": {**WORM_SHAPE, "cross_section": False},
           "device": {"kernels_by_tag": {"mc_prefetch": (4.95e-3, 2)},
                      "fits": 1}}
    assert read(rec) is None


def test_the_cell_reports_its_metrics():
    piece = run.load_cell(CELL)
    assert piece["cell"]["chips"] == 1
    assert [m["name"] for m, _ in piece["end_to_end"]] == ["fits_per_s",
                                                           "setup_s"]
    layer = [m["name"] for m, _ in piece["per_layer"]]
    assert "k2xs_roofline" in layer and "k2_roofline" not in layer
    assert {"api.setup_ms", "engine.run_ms", "post.ms",
            "device.idle_pct"} <= set(layer)
    assert set(piece["limits"]) == {"chi2_gap", "scale_gap", "bg_gap",
                                    "post_gap", "failed_share"}


def test_the_worm_reference_imports_nothing_of_the_program():
    code = ("import sys, torch\n"
            "from benchmark.reference import models\n"
            "m = models.get('Kholodenko')\n"
            "q = torch.logspace(7, 10, 20, dtype=torch.float64)\n"
            "m.ff(q, {'radius': 2e-9, 'lenKuhn': 2e-8,"
            " 'lenContour': torch.tensor([[3e-7], [6e-7]])})\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = set(eval(p.stdout.splitlines()[-1]))
    assert "mcsas_tpu_torch" not in mods and not mods & set(run.FORBIDDEN)
