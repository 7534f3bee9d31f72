# -*- coding: utf-8 -*-
"""PyTorch port: the measuring entry points ``mcsas_tpu_torch.tools.bench``,
``.roofline`` and ``.suite_stats`` (counterparts of the JAX package's
bench.py, tools/roofline.py with tools/mfu_report.py, and
tools/suite_stats.py).

They measure the card only, so here they must refuse, naming the card,
after their parsers took their flags.  Their workloads are bench.py's and
the drive audit's, read from those files with ``ast`` (never imported:
bench.py sets environment variables and imports jax).  The op model moved
out of ``chip_smoke.py`` gives PERF.md §6's bounds.  A suite row and the
certify rows run here on the CPU at a small size, where no kernel
launches; the table tier engages for the same rows as in the JAX
package."""
import ast
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu import data as jax_data  # noqa: E402
from mcsas_tpu.config import McSASConfig as JaxConfig  # noqa: E402
from mcsas_tpu.core.engine import McSASEngine as JaxEngine  # noqa: E402
from mcsas_tpu.models import get_model as jax_get_model  # noqa: E402
from mcsas_tpu_torch.api import fit  # noqa: E402
from mcsas_tpu_torch.core.engine import McSASEngine  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.tools import (bench, roofline, suite,  # noqa: E402
                                   suite_stats)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(num_contribs=20, num_reps=3, candidates_per_step=4,
             max_iterations=4000, chunk_steps=50)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    return env


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would measure it")


# ------------------------------------------- reading the JAX scripts

def _value(node, ns):
    """The value of an expression of the JAX scripts, evaluated on *ns*
    without builtins."""
    return eval(compile(ast.Expression(node), "<script>", "eval"),
                {"__builtins__": {}}, dict(ns))


def _assigns(tree):
    """{name: value node} of the simple assignments under *tree*."""
    return {t.id: n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Name)}


def _function(path, name):
    tree = ast.parse((REPO / path).read_text(encoding="utf-8"))
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _constant_keywords(call):
    return {k.arg: k.value.value for k in call.keywords
            if isinstance(k.value, ast.Constant)}


def _same_ranges(port, jax):
    """Equal active ranges; the cylinder rows keep suite.cylinder_bound's
    300e-9, which is one ulp below bench.py's 300 * nm."""
    assert (port or {}).keys() == (jax or {}).keys()
    for k in port or {}:
        np.testing.assert_allclose(port[k], jax[k], rtol=2e-16, atol=0)


# ----------------------------------------------------------- parsers

def test_parsers_take_their_flags():
    args = bench.build_parser().parse_args(
        ["--suite", "--only=sphere,cylinders-isotropic", "--only",
         "lma-dense-sphere", "--trace=/tmp/t", "--no-certify"])
    assert args.suite and args.no_certify and args.trace == "/tmp/t"
    assert args.only == ["sphere", "cylinders-isotropic",
                         "lma-dense-sphere"]
    args = bench.build_parser().parse_args([])
    assert not (args.suite or args.no_certify)
    assert args.only is None and args.trace is None
    args = roofline.build_parser().parse_args(["--only=fused,kab"])
    assert args.only == ["fused", "kab"]
    assert roofline.build_parser().parse_args([]).only is None
    args = suite_stats.build_parser().parse_args(
        ["--runs", "2", "--out", "s.json", "--only=sphere"])
    assert (args.runs, args.out, args.only) == (2, "s.json", ["sphere"])
    args = suite_stats.build_parser().parse_args([])
    assert (args.runs, args.out, args.only) == (5, None, None)
    for parser, bad in ((bench.build_parser(), ["--only=spheres"]),
                        (roofline.build_parser(), ["--only=fused,drive"]),
                        (suite_stats.build_parser(), ["--runs", "x"])):
        with pytest.raises(SystemExit) as e:
            parser.parse_args(bad)
        assert e.value.code == 2


@pytest.mark.parametrize("tool,argv", [
    ("bench", []), ("bench", ["--suite", "--only=sphere"]),
    ("roofline", ["--only=fused"]),
    ("suite_stats", ["--runs", "1", "--only=sphere"])])
def test_tools_exit_nonzero_without_a_card(tool, argv, tmp_path):
    """As a user runs them, from another directory: non-zero, no time;
    bench's one line holds value -1.0 and an error naming the card."""
    _no_card()
    r = subprocess.run([sys.executable, "-m",
                        f"mcsas_tpu_torch.tools.{tool}", *argv],
                       cwd=tmp_path, env=_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    if tool == "bench":
        (line,) = lines
        assert line["value"] == -1.0 and "CUDA device" in line["error"]
        assert not {"mc_s", "quickstart_s", "seconds_warm"} & set(line)
    else:
        assert not lines and "needs a CUDA card" in r.stderr
    assert not list(tmp_path.iterdir())


# --------------------------------------------- the workloads of bench.py

def test_suite_rows_are_bench_py():
    """The nine rows of bench.py's suite (bench.py:155-222): names and
    order, data, model, active set, ranges, χ² target, K, budget, local
    moves, fixed parameters and the config's constants."""
    fn = _function("bench.py", "suite")
    a = _assigns(fn)
    ns = {"ref": "REF", "refm": "REFM", "nm": 1e-9}
    configs = _value(a["configs"], ns)
    local = _value(a["local"], ns)
    fixed = _value(a["fixed"].func.value, ns)
    assert list(suite.BENCH_ROWS) == [c[0] for c in configs]
    call = a["cfg"]
    consts = _constant_keywords(call)
    names = {k.arg: k.value.id for k in call.keywords
             if isinstance(k.value, ast.Name)}
    assert names == {"max_iterations": "budget",
                     "candidates_per_step": "k_cand",
                     "convergence_criterion": "crit"}
    for name, path, model, active, ranges, crit, k, budget in configs:
        row = suite.BENCH_ROWS[name]
        assert row.name == name and row.model == model
        assert row.data == (path.replace("REFM/", "models/")
                            .replace("REF/", ""))
        assert row.active == active
        _same_ranges(row.ranges, ranges)
        assert (row.k_cand, row.budget) == (k, budget)
        assert row.local_moves == local.get(name, 0.0)
        assert row.fixed == fixed.get(name)
        cfg = row.config()
        assert cfg.convergence_criterion == crit
        assert {key: getattr(cfg, key) for key in consts} == consts
    assert consts == dict(num_contribs=300, num_reps=10, chunk_steps=1024,
                          seed=2026, max_retries=1, show_incomplete=True)


def test_suite_cylinder_rows_are_the_phases_binding():
    """The suite's cylinder rows fit what every cylinder phase of
    chip_smoke.py fits: cylinder_bound() and cylinder_config()."""
    golden = suite.cylinder_golden()
    row = suite.BENCH_ROWS["cylinders-isotropic"]
    assert row.bound(golden) == suite.cylinder_bound()
    assert row.config() == suite.cylinder_config()
    smeared = suite.BENCH_ROWS["cylinders-smeared"]
    assert smeared.bound(golden) == suite.cylinder_bound()
    assert smeared.config() == suite.cylinder_config()


def test_headline_config_is_bench_py():
    """bench.py:259-262: Sphere with its default binding and the
    headline config."""
    fn = _function("bench.py", "main")
    a = _assigns(fn)
    consts = _constant_keywords(a["cfg"])
    assert len(consts) == len(a["cfg"].keywords) == 8
    bind = a["bound"]
    assert (bind.func.attr == "bind" and not bind.args
            and not bind.keywords
            and bind.func.value.args[0].value == "Sphere")
    data, bound, cfg = roofline.headline_workload()
    assert {k: getattr(cfg, k) for k in consts} == consts
    assert bound == get_model("Sphere").bind() and data.count == 100
    assert data.filename.endswith("sasfit_sphere-10-1.dat")


def test_certify_configs_are_the_drive_audit():
    """The three tiers (tools/drive_audit.py:42-69) and the five rows
    bench.py certifies (bench.py:356-357), at the audit's config."""
    tree = ast.parse((REPO / "tools" / "drive_audit.py").read_text(
        encoding="utf-8"))
    audit = {c[0]: c for c in _value(_assigns(tree)["CONFIGS"],
                                     {"_NM": 1e-9})}
    for name, entry in bench.CERTIFY.items():
        want = audit[name]
        assert entry[:2] == (name, want[1].replace("testdata/", ""))
        assert entry[2:] == want[2:]
    a = _assigns(_function("bench.py", "certify"))
    assert _value(a["tiers"], {}) == tuple(bench.CERTIFY)
    assert _value(a["sharded_tiers"], {}) == bench.CERTIFY_SHARDED
    consts = _constant_keywords(_assigns(_function(
        "tools/drive_audit.py", "build_config"))["cfg"])
    assert consts["max_retries"] == 0
    for name in bench.CERTIFY:
        data, bound, cfg = bench.certify_workload(name)
        assert {k: getattr(cfg, k) for k in consts} == consts
        assert cfg.candidates_per_step == audit[name][5]
        assert cfg.local_moves == audit[name][6]
        assert bound.model.name == audit[name][2] and data.count > 0


# -------------------------------------------------------- the op model

def test_op_model_gives_perf_bounds(refdata):
    """K1 [Sphere] over one 2048-step chunk of the headline: 0.1017 ms,
    bounded by operations (PERF.md §6); and a K2 rows-in segment counted
    by hand."""
    data, bound, cfg = roofline.headline_workload()
    eng = McSASEngine(data, bound, cfg, device="cpu")
    s0 = eng._init_batch()
    s1 = s0.clone()
    s1.n_iter += cfg.chunk_steps * cfg.candidates_per_step
    ms, by = roofline.k1_bound(eng, s0, s1)
    assert (round(ms, 4), by) == (0.1017, "operations")
    n_bytes, ops = roofline.k1_work(eng, s0, s1)
    assert ops == 10 * 2048 * 128 * 100 * (12 + 14)
    # K2 rows in: R=2, N=3, K=4, Nq=5, P=1, 6 steps of which repetition 1
    # ran 4
    r, n, k, nq, s = 2, 3, 4, 5, 6
    fake = SimpleNamespace(spec=SimpleNamespace(k_cand=k),
                           consts=SimpleNamespace(n=nq))
    f32 = dict(dtype=torch.float32)
    st0 = SimpleNamespace(
        rset=torch.zeros(r, n, 1, **f32), ibank=torch.zeros(r, n, nq, **f32),
        ft=torch.zeros(r, nq, **f32), scale=torch.zeros(r, **f32),
        background=torch.zeros(r, **f32), conval=torch.zeros(r, **f32),
        n_iter=torch.zeros(r, dtype=torch.int32),
        n_moves=torch.zeros(r, dtype=torch.int32))
    st1 = SimpleNamespace(**vars(st0))
    st1.n_iter = torch.tensor([s * k, 4 * k], dtype=torch.int32)
    cands = torch.zeros(s, r, k, 1)
    rows = torch.zeros(s, r, k, nq)
    state = 4 * (r * n * 1 + r * n * nq + r * nq + 5 * r)     # 224 B
    want_bytes = 2 * state + 2 * nq * 4 + s * r * k * 4 + s * r * k * nq * 4
    assert roofline.k2_work(fake, st0, st1, cands, rows) == (
        want_bytes, (s + 4) * k * nq * 14)
    assert want_bytes == 1640
    ms, by = roofline.k2_bound(fake, st0, st1, cands, rows)
    assert by == "bytes" and ms == pytest.approx(1640 / 3.35e12 * 1e3)


# ------------------------------------------------- rows on the CPU

def test_suite_row_on_the_cpu():
    """A small Sphere suite row on the CPU: bench.py's keys plus device
    and launches, the χ², converged count and proposals of the fit's
    result as bench.py computes them (bench.py:229-243)."""
    line = bench.suite_row("sphere", device="cpu", **SMALL)
    assert set(line) == {
        "config", "model", "chi2_target", "seconds_warm", "seconds_cold",
        "max_chi2", "converged_reps", "proposals_per_sec", "total_iters",
        "pallas", "table", "local_moves", "device", "launches"}
    row = suite.BENCH_ROWS["sphere"]
    data = row.load()
    res = fit(data, row.bound(data), row.config(**SMALL), device="cpu")
    e = res.engine
    assert line["max_chi2"] == float(e.conval.max())
    assert line["converged_reps"] == int(e.converged.sum())
    assert line["total_iters"] == e.total_iters > 0
    assert line["proposals_per_sec"] > 0 and line["seconds_warm"] > 0
    assert (line["config"], line["model"], line["chi2_target"],
            line["local_moves"]) == ("sphere", "Sphere", 1.0, 0.0)
    assert line["device"] == "cpu" and not (line["pallas"] or line["table"])
    assert line["launches"] == {"K1": 0, "K2_table": 0, "K2_rows": 0}
    json.dumps(line)


def test_certify_rows_on_the_cpu():
    """The sphere tier at a small size on the CPU: two runs of one seed
    equal, inflation 1.0; two repetition shards equal the unsharded run;
    a row fails on an error, unequal counters or an inflation."""
    data, bound, cfg = bench.certify_workload("sphere")
    cfg = cfg.replace(**SMALL)
    row, base = bench.certify_tier(data, bound, cfg, device="cpu")
    assert row["n_iter_equal"] and row["inflation"] == 1.0
    assert row["total_iters"] == base.total_iters > 0
    sh = bench.certify_sharded(data, bound, cfg, base, device="cpu")
    assert sh["n_iter_equal"] and sh["contribs_equal"]
    assert sh["inflation"] == 1.0 and sh["mesh_platform"] == "cpu"
    cert = {"sphere": row, "sphere+sharded": sh}
    assert not (row["pallas"] or sh["pallas_shard"])
    assert bench.certify_failures(cert) == []
    bad = dict(cert, sphere=dict(row, inflation=1.5),
               worm={"error": "RuntimeError: x"},
               cyl=dict(sh, contribs_equal=False))
    assert bench.certify_failures(bad) == ["sphere", "worm", "cyl"]
    json.dumps(cert)


def test_headline_on_the_cpu(monkeypatch):
    """bench.py's headline at a small size on the CPU: its keys plus
    device, launches, total_iters and certify; value is the fit's wall
    only where every repetition converged (bench.py:316-317), and the
    quickstart keys only where the quickstart fit converged."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
    monkeypatch.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
    # table_ff 'on': the budget is far below the one where 'auto' bakes
    small = dict(num_contribs=10, num_reps=2, candidates_per_step=8,
                 max_iterations=8000, chunk_steps=100, max_retries=0,
                 table_ff="on")
    out = bench.headline(device="cpu", **small)
    assert {"metric", "value", "unit", "vs_baseline", "mc_s",
            "vs_baseline_mc", "proposals_per_sec", "converged_reps",
            "max_chi2", "device", "launches", "total_iters",
            "certify"} <= set(out)
    assert out["metric"] == bench.METRIC and out["unit"] == "s"
    data, bound, cfg = roofline.headline_workload(**small)
    e = McSASEngine(data, bound, cfg, device="cpu").run()
    assert (out["converged_reps"], out["max_chi2"], out["total_iters"]) == (
        int(e.converged.sum()), float(e.conval.max()), e.total_iters)
    assert e.converged.all() and out["value"] > 0 and out["mc_s"] > 0
    assert out["vs_baseline"] == bench.REFERENCE_SECONDS / out["value"]
    # three populations do not converge at this size: no quickstart keys
    assert "quickstart_s" not in out
    assert out["device"] == "cpu"
    assert out["launches"] == {"K1": 0, "K2_table": 0, "K2_rows": 0}
    cert = out["certify"]
    assert list(cert) == ["sphere", "sphere+sharded", "kholodenko-worm",
                          "kholodenko-worm+sharded", "cylinders-isotropic"]
    assert bench.certify_failures(cert) == []
    assert cert["cylinders-isotropic"]["table"]
    assert not cert["sphere"]["table"]
    json.dumps(out)


# ---------------------------------------------------- the table tier

@pytest.mark.parametrize("name", ["sphere", "gaussian-chain",
                                  "core-shell-sphere", "lma-dense-sphere",
                                  "cylinders-isotropic"])
def test_table_tier_engages_as_in_the_jax_package(name, monkeypatch):
    """The port's engine and the JAX package's, both on the CPU at the
    row's binding and config, agree on whether the rows come from a
    table (64-row tables: the decision does not depend on their size)."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
    monkeypatch.delenv("MCSAS_TPU_TABLE_CACHE_DIR", raising=False)
    row = suite.BENCH_ROWS[name]
    data = row.load()
    bound = row.bound(data)
    cfg = row.config()
    port = McSASEngine(data, bound, cfg, device="cpu")
    jdata = (jax_data.load(REPO / "testdata" / row.data)
             if not row.data.startswith("synth:")
             else jax_data.from_raw(data.raw, title=data.title,
                                    config=jax_data.DataConfig(n_bin=0)))
    np.testing.assert_array_equal(jdata.q, data.q)
    jbound = jax_get_model(row.model).bind(
        active=bound.active, active_ranges=dict(zip(bound.active,
                                                    bound.ranges)),
        fixed=row.fixed)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "num_contribs", "num_reps", "max_iterations", "chunk_steps",
        "candidates_per_step", "seed", "max_retries",
        "convergence_criterion", "local_moves", "show_incomplete")})
    jax_eng = JaxEngine(jdata, jbound, jcfg)
    assert port.uses_table == jax_eng.uses_table
    assert port.uses_table == (name == "cylinders-isotropic")


# -------------------------------------------------- suite statistics

def test_suite_stats_summarize():
    """Median, min, max and the relative spread per config over the
    runs; the converged count of every run and the cards seen."""
    def line(config, warm, iters, conv=10):
        return {"config": config, "seconds_warm": warm,
                "total_iters": iters, "converged_reps": conv,
                "device": "H100, 700.00 W"}
    runs = [[line("sphere", 0.05, 100), line("cyl", 0.08, 7)],
            [line("sphere", 0.04, 100), line("cyl", 0.10, 7, 9)],
            [line("sphere", 0.06, 100)]]
    out = suite_stats.summarize(runs)
    sph = out["sphere"]
    assert sph["n"] == 3 and sph["converged_reps"] == [10, 10, 10]
    assert sph["seconds_warm"]["median"] == 0.05
    assert sph["seconds_warm"]["spread"] == pytest.approx(0.4)
    assert sph["total_iters"] == {"median": 100, "min": 100, "max": 100,
                                  "spread": 0.0}
    assert out["cyl"]["seconds_warm"]["median"] == pytest.approx(0.09)
    assert out["cyl"]["converged_reps"] == [10, 9]
    assert out["cyl"]["device"] == ["H100, 700.00 W"]
