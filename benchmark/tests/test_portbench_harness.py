"""The harness on the CPU: the metric arithmetic, the trace's reduction,
the op model against PERF.md's bounds, the import check, a cell added as
files only, and spans that leave results unchanged."""
import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, tiny
from benchmark import opmodel, run, stats


def test_rate_and_p95_with_failed_fits():
    fits = [{"wall_s": 0.1 * (k + 1), "converged": k != 3,
             "total_iters": 1, "engine_s": 0.05} for k in range(40)]
    rec = {"fits": fits, "window_s": 8.0}
    assert run.reader("fits_per_s")(rec) == pytest.approx(39 / 8.0)
    # the 38th of 40 (nearest rank); the failed fit counts as the window
    walls = sorted([8.0] + [f["wall_s"] for f in fits if f["converged"]])
    assert run.reader("fit_p95_s")(rec) == walls[37]
    assert stats.p95([1.0] * 19 + [2.0], [False] * 19 + [True], 9.0) == 1.0
    assert stats.p95([1.0] * 18 + [2.0, 3.0], [False] * 20, 9.0) == 2.0
    assert run.reader("engine.run_ms")(rec) == pytest.approx(50.0)
    v = [1.0, 1.1, 0.9, 1.05, 0.95, 1.2]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def _ev(name, dev, s, e):
    return run._Ev(name, dev, float(s), float(e))


def test_idle_share_and_gaps_from_synthetic_events():
    events = [
        _ev("window", "cpu", 0, 100), _ev("fit", "cpu", 0, 80),
        _ev("engine.run", "cpu", 8, 60), _ev("post", "cpu", 60, 78),
        _ev("void mc_chunk_kernel<0, 5, 8>(ChunkParams)", "cuda", 10, 30),
        _ev("void mc_chunk_kernel<0, 5, 8>(ChunkParams)", "cuda", 25, 40),
        _ev("reduce_kernel", "cuda", 62, 65),
        _ev("reduce_kernel", "cuda", 70, 75),
        _ev("engine.run", "cuda", 8, 60),      # an annotation, not work
    ]
    dev = run.device_record(events)
    assert dev["window_s"] == pytest.approx(100e-6)
    assert dev["busy_s"] == pytest.approx(38e-6)
    assert dev["kernels_by_tag"]["mc_chunk"] == (pytest.approx(35e-6), 2)
    idle = dev["idle_s"]
    assert idle[run.SPAN_LABELS["fit"]] == pytest.approx(10e-6)
    assert idle[run.SPAN_LABELS["engine.run"]] == pytest.approx(22e-6)
    assert idle[run.SPAN_LABELS["post"]] == pytest.approx(5e-6)
    assert idle[run.SPAN_LABELS["window"]] == pytest.approx(25e-6)
    rec = {"device": dev}
    assert run.reader("device.idle_pct")(rec) == pytest.approx(62.0)
    b = run.breakdown(dev)
    assert b["device_ops"][0][0].startswith("void mc_chunk_kernel")
    assert len(b["idle_gaps"]) == 4


SPHERE_SHAPE = {"model": "Sphere", "nq": 100, "reps": 10, "contribs": 300,
                "params": 1, "table_values": 0, "table_axes": 0,
                "intensity_table": False, "cross_section": False}


def _files(*names):
    return [json.loads((ROOT / "benchmark" / n).read_text()) for n in names]


def test_work_shape_from_the_cells_files_alone():
    sphere, cyl = _files("configs/sphere-k128.json",
                         "configs/cylinder-table.json")
    plain, slit = _files("traffic/cylinder-series.json",
                         "traffic/cylinder-slit-series.json")
    shape = run.work_shape(sphere, _files("traffic/sphere-series.json")[0],
                           100)
    assert shape == SPHERE_SHAPE
    shape = run.work_shape(cyl, plain, 100)
    assert shape == {**SPHERE_SHAPE, "model": "CylindersIsotropic",
                     "table_values": 4096 * 100, "table_axes": 1}
    assert run.work_shape(cyl, slit, 100)["intensity_table"]


def test_op_model_against_the_kernel_table():
    # K1 Sphere, a 2048-step chunk: 0.1017 ms by operations
    proposals = 2048 * 10 * 128
    ms = 1e3 * opmodel.bound_s(opmodel.k1_launch_bytes(SPHERE_SHAPE),
                               proposals * opmodel.k1_proposal_ops(
                                   SPHERE_SHAPE))
    assert round(ms, 4) == 0.1017
    # K2's table entry, the cylinder's 131-step segment: 0.0048 ms
    cyl = {**SPHERE_SHAPE, "model": "CylindersIsotropic",
           "table_values": 4096 * 100, "table_axes": 1}
    seg = 131 * 10 * 128
    ms = 1e3 * opmodel.bound_s(
        opmodel.k2_launch_bytes(cyl) + seg * opmodel.k2_proposal_bytes(cyl),
        seg * opmodel.k2_proposal_ops(cyl))
    assert round(ms, 4) == 0.0048
    rec = {"shape": SPHERE_SHAPE, "fits": [{"total_iters": proposals}],
           "device": {"kernels_by_tag": {"mc_chunk": (20.356e-3, 1)},
                      "fits": 1}}
    assert run.reader("k1_roofline")(rec) == pytest.approx(
        100 * 0.1017 / 20.356, rel=1e-3)
    assert run.reader("k2_roofline")(rec) is None
    rec = {"shape": cyl, "fits": [{"total_iters": seg}],
           "device": {"kernels_by_tag": {"mc_prefetch": (1.311e-3, 1)},
                      "fits": 1}}
    assert run.reader("k2_roofline")(rec) == pytest.approx(
        100 * 1e-3 * ms / 1.311e-3)
    assert run.reader("k1_roofline")(rec) is None
    assert opmodel.roofline_pct(1, 1, 0.0, 1, 1) is None


def _python(code, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True,
                          env={**os.environ, **env}, timeout=600)


def test_without_a_card_no_result_and_no_jax():
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "sphere-series", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=600)
    assert p.returncode != 0
    assert "{" not in p.stdout and "CUDA" in p.stderr
    code = ("import sys, json\n"
            "from benchmark import run\n"
            "rc = run.main(['--workload', 'sphere-series', '--seed', '1',"
            " '--seconds', '1'])\n"
            "print(json.dumps([rc, sorted({m.split('.')[0] for m in "
            "sys.modules})]))\n")
    rc, mods = json.loads(_python(code, CUDA_VISIBLE_DEVICES="")
                          .stdout.splitlines()[-1])
    assert rc != 0 and not set(mods) & set(run.FORBIDDEN)


def test_a_cpu_run_loads_no_jax_and_the_reference_no_program():
    code = ("import sys, time, json\n"
            "sys.path.insert(0, 'benchmark/tests')\n"
            "from conftest import tiny\n"
            "from benchmark import run\n"
            "p = tiny(run.load_cell('sphere-series'))\n"
            "rec = run.run_cell(p, 3, 0.5, device='cpu',"
            " t_start=time.perf_counter())\n"
            "print(json.dumps(run.forbidden_modules()))\n")
    p = _python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.splitlines()[-1]) == []
    code = ("import sys, numpy as np\n"
            "from benchmark.reference import core, prep, models\n"
            "from benchmark import opmodel, run, stats\n"
            "run.generator('gaussian_sizes')\n"
            "import json\n"
            "cfg = json.load(open('benchmark/configs/cylinder-table.json'))\n"
            "fg = prep.derive(np.column_stack([np.geomspace(.01, 2, 30), "
            "np.ones(30), np.full(30, .01)]), {'n_bin': 0})\n"
            "core.reference(cfg, fg, np.full((2, 3, 1), 1e-8))\n"
            "models.get('Sphere')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = _python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = set(eval(p.stdout.splitlines()[-1]))
    assert "mcsas_tpu_torch" not in mods and not mods & set(run.FORBIDDEN)


def test_a_cell_added_as_files_only(tmp_path):
    """A configuration, a traffic mix with a generator of its own, a
    per-layer metric and a limits file added as new files, and entries
    added to BENCHMARK.json: the harness finds and runs them by name, with
    no edit of a file."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    here = tmp_path / "benchmark"
    conf = json.loads((here / "configs/sphere-k128.json").read_text())
    conf.update(numContribs=40, numReps=2, candidatesPerStep=8,
                chunkSteps=256, maxIterations=400_000)
    (here / "configs/sphere-small.json").write_text(json.dumps(conf))
    traffic = json.loads((here / "traffic/sphere-series.json").read_text())
    traffic.update(basis_nodes=256, strata=8, check_fits=2,
                   mean_nm=[8.0, 12.0])
    shutil.copy(here / "generators/gaussian_sizes.py",
                here / "generators/gaussian-narrow.py")
    traffic["generator"] = "gaussian-narrow"
    (here / "traffic/sphere-narrow.json").write_text(json.dumps(traffic))
    (here / "metrics/fits_attempted.py").write_text(
        "def read(rec):\n    return len(rec['fits'])\n")
    (here / "limits/sphere-narrow-small.json").write_text(
        (here / "limits/sphere-series.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sphere-small", "source": "test",
                             "file": "benchmark/configs/sphere-small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "sphere-narrow-small",
                               "config": "sphere-small",
                               "traffic": "sphere-narrow", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "fits_attempted", "unit": "fits",
                               "better": "higher", "source": "host_clock",
                               "layer": "api", "moves": "fits_per_s",
                               "workloads": ["sphere-narrow-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    piece = run.load_cell("sphere-narrow-small", root=tmp_path)
    assert piece["config"]["numContribs"] == 40
    assert piece["traffic"]["mean_nm"] == [8.0, 12.0]
    assert "gaussian_narrow" in piece["generator"].__module__
    assert "fits_attempted" in [m["name"] for m, _ in piece["per_layer"]]
    rec = run.run_cell(piece, 11, 0.5, device="cpu")
    read = dict((m["name"], r) for m, r in piece["per_layer"])
    assert read["fits_attempted"](rec) == len(rec["fits"]) > 0
    line = run.result_line(piece, rec, False, "cpu", 1)
    assert list(line)[-1] == "checks" and line["correct"]


def test_spans_leave_a_fit_unchanged():
    piece = tiny(run.load_cell("sphere-series"))
    api, bound, base, data_cfg = run.program_setup(piece["config"],
                                                   piece["traffic"])
    from mcsas_tpu_torch.data import from_raw
    src = piece["generator"](piece["traffic"], 4)
    cfg = base.replace(seed=src.fit_seed(0))

    def one():
        api._ENGINE_CACHE.clear()
        data = from_raw(src.frame(0), config=data_cfg)
        return api.fit(data, bound, cfg, device="cpu")
    plain = one()
    spans = run.Spans("cpu")
    with spans.installed(api):
        traced = one()
    assert all(len(spans.seconds[k]) == 1
               for k in ("api.setup", "engine.run", "post"))
    assert np.array_equal(plain.engine.contribs, traced.engine.contribs)
    assert np.array_equal(plain.engine.conval, traced.engine.conval)
    assert np.array_equal(plain.fractions.fraction["vol"],
                          traced.fractions.fraction["vol"])


def test_a_traced_cpu_run_reads_its_profile():
    piece = tiny(run.load_cell("sphere-series"))
    rec = run.run_cell(piece, 5, 0.5, trace=True, device="cpu")
    dev = rec["device"]
    assert 0 < dev["window_s"] and dev["busy_s"] == 0.0
    assert dev["fits"] == len(rec["fits"])
    line = run.result_line(piece, rec, True, "cpu", 1)
    assert {"api.setup_ms", "engine.run_ms", "post.ms",
            "device.idle_pct"} <= set(line["metrics"])
    assert "k1_roofline" not in line["metrics"]    # no device time
    assert line["breakdown"]["idle_gaps"]
