"""The cell ``sphere-plugin-series`` on the CPU at a test's size: a user's
model file named by the configuration (``modelFile``), loaded by the
program's plugin loader in set-up; the check that decides ``correct`` on
K2's rows-in route (the program passes, the control fails, and so does
each fault of ``test_portbench_correct.py``, the state left unchanged by
the route's own segment); the plugin's form factor against the plain
reference and the built-in Sphere; the readers of ``k2rows_roofline`` and
``engine.eager_ms``.  On the card ``test_portbench_cuda.py`` runs the cell
at its own size: it reads its cells from ``BENCHMARK.json``."""
import ast
import copy
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny
from benchmark import opmodel, run
from benchmark.reference import core, models, prep
from test_portbench_correct import _altered, _half_the_points
from test_portbench_harness import SPHERE_SHAPE, _ev

CELL = "sphere-plugin-series"
PLUGIN = ROOT / "benchmark/plugins/SpherePlugin.py"
CONFIG = json.loads((ROOT / "benchmark/configs/sphere-plugin-rows.json")
                    .read_text())
TRAFFIC = json.loads((ROOT / "benchmark/traffic/sphere-series.json")
                     .read_text())


def _plugin():
    from mcsas_tpu_torch.models import load_model_file
    (model,) = load_model_file(str(PLUGIN))
    return model


def _unchanged_segment(monkeypatch):
    """A segment of K2's rows-in route (its plain version on the CPU) that
    returns its state unchanged."""
    from mcsas_tpu_torch.ops import mc_kernel
    monkeypatch.setattr(mc_kernel, "prefetch_reference",
                        lambda state, ri, *a, **kw: (state, ri))


def _run(seed, **kw):
    piece = tiny(run.load_cell(CELL))
    rec = run.run_cell(piece, seed, 1.0, device="cpu", **kw)
    return piece, rec


def test_program_passes_and_control_fails():
    piece, rec = _run(2 ** 31 + 21, control=True)
    assert rec["shape"]["model"] == "SpherePlugin"
    assert run.passes(rec["checks"], piece["limits"]), rec["checks"]
    assert not run.passes(rec["control"], piece["limits"]), rec["control"]


@pytest.mark.parametrize("fault",
                         [_unchanged_segment, _half_the_points, _altered],
                         ids=["state_unchanged", "half_the_points",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    piece, rec = _run(2 ** 31 + 22)
    assert not run.passes(rec["checks"], piece["limits"]), rec["checks"]


def _frame_data(piece, i=0, seed=4):
    from mcsas_tpu_torch.data import from_raw
    src = piece["generator"](piece["traffic"], seed)
    _, _, _, data_cfg = run.program_setup(piece["config"], piece["traffic"])
    return src, from_raw(src.frame(i), config=data_cfg)


def test_model_file_binds_the_users_object_on_the_rows_entry():
    from mcsas_tpu_torch.core.engine import McSASEngine
    from mcsas_tpu_torch.models import get_model
    from mcsas_tpu_torch.ops import mc_kernel
    piece = tiny(run.load_cell(CELL))
    api, bound, base, _ = run.program_setup(piece["config"],
                                            piece["traffic"])
    assert bound.model.name == "SpherePlugin"
    assert bound.model is get_model("SpherePlugin")
    assert bound.model is not get_model("Sphere")
    assert bound.model.ff is not get_model("Sphere").ff
    assert bound.active == ("radius",)
    assert bound.ranges == ((1e-9, 1e-6),)
    _, data = _frame_data(piece)
    eng = McSASEngine(data, bound, base, device="cpu")
    assert eng.prefetch_entry == "rows" and eng.runs_prefetch
    assert not mc_kernel.supports(eng) and not eng.uses_table


def test_without_the_key_the_registrys_own_object():
    from mcsas_tpu_torch.models import get_model
    for cell in ("sphere-series", "core-shell-series"):
        piece = run.load_cell(cell)
        assert "modelFile" not in piece["config"]
        _, bound, _, _ = run.program_setup(piece["config"], piece["traffic"])
        assert bound.model is get_model(piece["config"]["model"])


@pytest.mark.parametrize("name", ["../SpherePlugin", "plugins/SpherePlugin",
                                  ".SpherePlugin", "..", ""])
def test_a_model_file_name_outside_plugins_is_refused(name):
    config = {**CONFIG, "modelFile": name}
    with pytest.raises(ValueError, match="bad model file name"):
        run.program_setup(config, TRAFFIC)


def test_the_plugin_file_is_a_users_own():
    """The file imports of the port only SASModel, ParamSpec and units,
    and its model keeps nothing of the registry's Sphere."""
    from mcsas_tpu_torch.models import get_model
    tree = ast.parse(PLUGIN.read_text())
    port = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "mcsas_tpu_torch"):
            port[node.module] = {a.name for a in node.names}
        elif isinstance(node, ast.Import):
            assert not any(a.name.startswith("mcsas_tpu") for a in node.names)
    assert port == {"mcsas_tpu_torch.models": {"SASModel", "ParamSpec"},
                    "mcsas_tpu_torch.utils.units": {"NM", "ANGSTROM_SLD"}}
    model, sphere = _plugin(), get_model("Sphere")
    assert model.elementwise_q and model.ff_table_factory is None
    assert model.ff_fast is None
    for fn in ("ff", "volume", "absvolume", "surface"):
        assert getattr(model, fn).__module__ == "mcsas_tpu_torch.user." \
            "SpherePlugin"
        assert getattr(model, fn) is not getattr(sphere, fn)
    assert model.params == sphere.params
    assert model.default_active == sphere.default_active


def _x_points(lo, hi, n=40):
    return torch.as_tensor(np.geomspace(lo, hi, n), dtype=torch.float64)


def test_plugin_against_the_reference_in_float64():
    """Both sides of the plugin's float64 series switch (0.05), away from
    the reference's own (1e-3) by enough that its closed form keeps 1e-12
    (its cancellation costs about 3ε/x²), and away from F's zeros."""
    model, ref = _plugin(), models.get("SpherePlugin")
    assert ref.ff is models.get("Sphere").ff
    assert ref.DEFAULTS == {"sld": 1e14}
    q = torch.as_tensor([1e7], dtype=torch.float64)
    for x in (_x_points(1e-6, 9e-4), _x_points(0.045, 0.0499, 5),
              _x_points(0.0501, 4.0), _x_points(4.6, 7.5)):
        r = x / q
        p = {"radius": r, "sld": 1e14}
        torch.testing.assert_close(model.ff(q, p), ref.ff(q, p),
                                   rtol=1e-12, atol=0)
        torch.testing.assert_close(model.volume(p), ref.volume(p),
                                   rtol=1e-12, atol=0)
        torch.testing.assert_close(model.absvolume(p), ref.absvolume(p),
                                   rtol=1e-12, atol=0)


def test_plugin_against_the_builtin_sphere_in_float32():
    """On the cell's grid (0.001-10 nm⁻¹) and active range (1 nm-1 µm),
    as the engine's rows take it: the closed form is the built-in's
    expression, so equal; the series (x < 0.5) is written in another
    order than the built-in's Horner form, so a few float32 roundings
    apart, 2e-7 of F ≈ 1 there (at most four roundings of 6e-8)."""
    from mcsas_tpu_torch.models import get_model
    model, sphere = _plugin(), get_model("Sphere")
    q = torch.as_tensor(np.asarray(TRAFFIC["q_nm"]) * prep.Q_TO_SI,
                        dtype=torch.float32)
    r = torch.as_tensor(np.geomspace(1e-9, 1e-6, 301),
                        dtype=torch.float32)[:, None]
    p = {"radius": r, "sld": torch.tensor(1e14, dtype=torch.float32)}
    a, b = model.ff(q, p), sphere.ff(q, p)
    assert a.dtype == torch.float32
    small = (q * r).abs() < 0.5
    assert small.any() and (~small).any()
    assert torch.equal(a[~small], b[~small])
    torch.testing.assert_close(a[small], b[small], rtol=2e-7, atol=0)
    assert torch.equal(model.volume(p), sphere.volume(p))
    assert torch.equal(model.absvolume(p), sphere.absvolume(p))


def test_a_plugin_fit_on_the_rows_route_is_judged_as_on_the_card(
        monkeypatch):
    """One sphere-series frame through ``api.fit`` with the loaded plugin,
    seeded, on the CPU: K2's plain version takes every segment (no K1
    chunk), and the reference judges the outputs as the harness does."""
    from mcsas_tpu_torch.ops import mc_kernel
    segments = []
    orig = mc_kernel.prefetch_reference

    def counted(*a, **kw):
        segments.append(a[4].shape)
        return orig(*a, **kw)
    monkeypatch.setattr(mc_kernel, "prefetch_reference", counted)
    monkeypatch.setattr(mc_kernel, "chunk_reference", None)
    piece = tiny(run.load_cell(CELL))
    api, bound, base, _ = run.program_setup(piece["config"],
                                            piece["traffic"])
    src, data = _frame_data(piece, i=5, seed=2 ** 31 + 5)
    api._ENGINE_CACHE.clear()
    res = api.fit(data, bound, base.replace(seed=src.fit_seed(5)),
                  device="cpu")
    assert segments and all(s[-1] == data.count for s in segments)
    assert bool(res.engine.converged.all())
    out = run.outputs(res)
    fg = prep.derive(src.frame(5), piece["traffic"]["data"])
    ref = core.reference(piece["config"], fg, out["contribs"])
    gaps = core.judge(out, ref, fg, out["engine"]["conval"] <= 1.0)
    limits = piece["limits"]
    assert all(gaps[k] <= limits[k] for k in gaps), gaps


PLUGIN_SHAPE = {**SPHERE_SHAPE, "model": "SpherePlugin"}


def test_work_shape_and_the_rows_op_model():
    assert run.work_shape(CONFIG, TRAFFIC, 100) == PLUGIN_SHAPE
    # a 131-step segment of 10 × 128 proposals: the kernel table's 0.0209
    # ms, by bytes
    seg = 131 * 10 * 128
    n_bytes = (opmodel.k2rows_launch_bytes(PLUGIN_SHAPE)
               + seg * opmodel.k2rows_proposal_bytes(PLUGIN_SHAPE))
    n_ops = seg * opmodel.k2rows_proposal_ops(PLUGIN_SHAPE)
    assert n_bytes / opmodel.HBM_BYTES_PER_S > n_ops / opmodel.F32_OPS_PER_S
    assert round(1e3 * opmodel.bound_s(n_bytes, n_ops), 4) == 0.0209
    assert opmodel.k2rows_launch_bytes(PLUGIN_SHAPE) == (
        2 * opmodel.state_bytes(PLUGIN_SHAPE) + 2 * 100 * 4)
    assert opmodel.k2rows_proposal_bytes(PLUGIN_SHAPE) == 4 * (100 + 1)
    assert opmodel.k2rows_proposal_ops(PLUGIN_SHAPE) == 100 * 14


def test_k2rows_roofline_reads_the_op_model():
    read = run.reader("k2rows_roofline")
    seg = 131 * 10 * 128
    rec = {"shape": PLUGIN_SHAPE,
           "fits": [{"total_iters": 3 * seg}, {"total_iters": 10 ** 9}],
           "device": {"kernels_by_tag": {"mc_prefetch": (2.76e-3, 3)},
                      "fits": 1}}
    bound = opmodel.bound_s(
        3 * opmodel.k2rows_launch_bytes(PLUGIN_SHAPE)
        + 3 * seg * opmodel.k2rows_proposal_bytes(PLUGIN_SHAPE),
        3 * seg * opmodel.k2rows_proposal_ops(PLUGIN_SHAPE))
    assert read(rec) == pytest.approx(100.0 * bound / 2.76e-3, rel=1e-12)
    # PR 12's 0.920 ms a segment: 2.28 % in the kernel table
    assert 2.2 < read(rec) < 2.4
    # no K2 time, no trace, or a table on K2
    assert read({**rec, "device": {"kernels_by_tag": {}, "fits": 1}}) is None
    assert read({"shape": PLUGIN_SHAPE, "fits": rec["fits"]}) is None
    cyl = {**PLUGIN_SHAPE, "model": "CylindersIsotropic",
           "table_values": 4096 * 100, "table_axes": 1}
    assert read({**rec, "shape": cyl}) is None
    # the table entry's reader is silent on the rows entry's shape
    assert run.reader("k2_roofline")(rec) is None
    assert run.reader("k2xs_roofline")(rec) is None


# the harness test's events (test_portbench_harness.py) with K2 and
# eager operations inside and outside two engine runs
EVENTS = [
    _ev("window", "cpu", 0, 100), _ev("fit", "cpu", 0, 80),
    _ev("engine.run", "cpu", 8, 60), _ev("post", "cpu", 60, 78),
    _ev("void mc_chunk_kernel<0, 5, 8>(ChunkParams)", "cuda", 10, 30),
    _ev("void mc_chunk_kernel<0, 5, 8>(ChunkParams)", "cuda", 25, 40),
    _ev("reduce_kernel", "cuda", 62, 65),
    _ev("reduce_kernel", "cuda", 70, 75),
    _ev("engine.run", "cuda", 8, 60),      # an annotation, not work
]
EXTRA = [
    _ev("fit", "cpu", 80, 100), _ev("engine.run", "cpu", 82, 98),
    _ev("void mc_prefetch_kernel<3, 3, 0>(PrefetchParams, int, int)",
        "cuda", 90, 96),
    _ev("vectorized_elementwise_kernel", "cuda", 83, 85),     # the rows
    _ev("vectorized_elementwise_kernel", "cuda", 86, 89),
    _ev("Memcpy DtoH (Device -> Pinned)", "cuda", 96, 97),
    _ev("distribution_elementwise", "cuda", 40, 44),          # a draw
    _ev("reduce_kernel", "cuda", 97, 100),     # its middle past the run
]


def test_device_record_keeps_its_keys_and_adds_the_eager_time():
    dev = run.device_record(EVENTS)
    assert set(dev) == {"busy_s", "window_s", "kernels", "kernels_by_tag",
                        "idle_s", "engine_eager_s"}
    assert dev["busy_s"] == pytest.approx(38e-6)
    assert dev["window_s"] == pytest.approx(100e-6)
    assert dev["kernels_by_tag"] == {"mc_chunk": (pytest.approx(35e-6), 2)}
    assert dev["kernels"] == {
        "void mc_chunk_kernel<0, 5, 8>(ChunkParams)": (
            pytest.approx(35e-6), 2),
        "reduce_kernel": (pytest.approx(8e-6), 2)}
    assert dev["idle_s"] == {
        run.SPAN_LABELS["fit"]: pytest.approx(10e-6),
        run.SPAN_LABELS["engine.run"]: pytest.approx(22e-6),
        run.SPAN_LABELS["post"]: pytest.approx(5e-6),
        run.SPAN_LABELS["window"]: pytest.approx(25e-6)}
    # K1 inside the run is not eager, the reductions lie in the post pass
    assert dev["engine_eager_s"] == 0.0
    dev = run.device_record(EVENTS + EXTRA)
    # the rows (5 µs), the draw (4) and the copy (1) inside the two runs
    assert dev["engine_eager_s"] == pytest.approx(10e-6)
    assert dev["kernels_by_tag"]["mc_prefetch"] == (pytest.approx(6e-6), 1)
    rec = {"device": {**dev, "fits": 2}}
    assert run.reader("engine.eager_ms")(rec) == pytest.approx(5e-3)


def test_engine_eager_ms_is_silent_without_device_work():
    read = run.reader("engine.eager_ms")
    assert read({"fits": []}) is None
    dev = run.device_record(EVENTS + EXTRA)
    assert read({"device": {**dev, "fits": 0}}) is None
    cpu = run.device_record([_ev("window", "cpu", 0, 10),
                             _ev("engine.run", "cpu", 1, 9)])
    assert cpu["busy_s"] == 0.0
    assert read({"device": {**cpu, "fits": 1}}) is None


def test_the_cell_reports_its_metrics():
    piece = run.load_cell(CELL)
    assert piece["cell"]["chips"] == 1
    assert piece["cell"]["traffic"] == "sphere-series"
    assert piece["traffic"] == TRAFFIC
    assert [m["name"] for m, _ in piece["end_to_end"]] == [
        "fits_per_s", "fit_p95_s", "setup_s"]
    layer = [m["name"] for m, _ in piece["per_layer"]]
    assert {"k2rows_roofline", "engine.eager_ms", "api.setup_ms",
            "engine.run_ms", "post.ms", "device.idle_pct"} == set(layer)
    assert set(piece["limits"]) == {"chi2_gap", "scale_gap", "bg_gap",
                                    "post_gap", "failed_share"}
    assert piece["limits"]["failed_share"] == 0.3
    sphere = json.loads((ROOT / "benchmark/configs/sphere-k128.json")
                        .read_text())
    plugin = copy.deepcopy(CONFIG)
    assert (plugin.pop("model"), plugin.pop("modelFile")) == (
        "SpherePlugin", "SpherePlugin")
    del sphere["model"]
    for c in (sphere, plugin):
        del c["source"], c["assumed"]
    assert plugin == sphere
    # no other cell reads either new metric
    for other in ("sphere-series", "cylinder-series", "cylinder-slit-series",
                  "worm-series", "core-shell-series"):
        names = [m["name"] for m, _ in run.load_cell(other)["per_layer"]]
        assert not {"k2rows_roofline", "engine.eager_ms"} & set(names)


def test_a_traced_cpu_run_of_the_cell():
    piece = tiny(run.load_cell(CELL))
    rec = run.run_cell(piece, 6, 0.5, trace=True, device="cpu")
    line = run.result_line(piece, rec, True, "cpu", 1)
    # no device time on the CPU: both device readers stay silent
    assert not {"k2rows_roofline", "engine.eager_ms"} & set(line["metrics"])
    assert {"api.setup_ms", "engine.run_ms", "post.ms"} <= set(
        line["metrics"])


def test_the_plugin_reference_imports_nothing_of_the_program():
    code = ("import sys, torch\n"
            "from benchmark.reference import models\n"
            "m = models.get('SpherePlugin')\n"
            "q = torch.logspace(6, 10, 20, dtype=torch.float64)\n"
            "m.ff(q, {**m.DEFAULTS, 'radius': torch.tensor([[3e-9]])})\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = set(eval(p.stdout.splitlines()[-1]))
    assert "mcsas_tpu_torch" not in mods and not mods & set(run.FORBIDDEN)
