# -*- coding: utf-8 -*-
"""PyTorch port: the measuring tools ``mcsas_tpu_torch.tools.coldstart``
and ``mcsas_tpu_torch.tools.rep_scaling`` (counterparts of the JAX
package's tools/coldstart.py and tools/rep_scaling.py).  They measure the
card only, so here they must refuse to run, naming the card, after their
parsers took their flags; their workloads are the JAX tools' configs.
On the card ``chip_smoke.py`` phase 23 runs them."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcsas_tpu_torch.tools import coldstart, rep_scaling, suite  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    return env


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would measure it")


def test_parsers_take_their_flags():
    args = coldstart.build_parser().parse_args(
        ["--tier=sphere", "--tier", "cylinders-table", "--prewarm"])
    assert args.tier == ["sphere", "cylinders-table"] and args.prewarm
    assert coldstart.build_parser().parse_args([]).tier is None
    args = rep_scaling.build_parser().parse_args(
        ["--reps", "1,10,132", "--contribs", "3000", "--tier",
         "cylinders-table", "--json", "out.json"])
    assert (args.reps, args.contribs, args.tier, args.json) == (
        "1,10,132", 3000, "cylinders-table", "out.json")
    args = rep_scaling.build_parser().parse_args([])
    assert args.reps == "1,2,5,10,20,40,80,132"
    assert (args.contribs, args.tier) == (300, "sphere")
    for parser, bad in ((coldstart.build_parser(), ["--tier=sphere2"]),
                        (rep_scaling.build_parser(), ["--tier", "worm"])):
        with pytest.raises(SystemExit) as e:
            parser.parse_args(bad)
        assert e.value.code == 2


@pytest.mark.parametrize("tool,argv", [
    (coldstart, ["--tier=sphere", "--prewarm"]),
    (rep_scaling, ["--reps", "1,132", "--contribs", "3000", "--tier",
                   "cylinders-table"])])
def test_tools_refuse_without_a_card(tool, argv, tmp_path):
    """main() exits with an error naming the card and writes nothing; it
    never times the CPU."""
    _no_card()
    out = tmp_path / "rows.json"
    if tool is rep_scaling:
        argv = argv + ["--json", str(out)]
    with pytest.raises(SystemExit) as e:
        tool.main(argv)
    assert "CUDA card" in str(e.value.code)
    assert not out.exists()


@pytest.mark.parametrize("name", ["coldstart", "rep_scaling"])
def test_tools_exit_nonzero_without_a_card(name, tmp_path):
    """As a user runs them: python -m mcsas_tpu_torch.tools.<name>."""
    _no_card()
    r = subprocess.run([sys.executable, "-m",
                        f"mcsas_tpu_torch.tools.{name}"], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "needs a CUDA card" in r.stderr
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("tier", coldstart.TIERS)
def test_coldstart_tiers_are_the_jax_tools(tier):
    """The four tiers at the JAX tool's configs (tools/coldstart.py:
    37-61), their active ranges finite as fit() makes them."""
    data, bound, cfg = coldstart.tier_workload(tier)
    want = dict(num_contribs=300, num_reps=10, seed=2026, max_retries=1,
                candidates_per_step=128, chunk_steps=2048,
                max_iterations=8_000_000, local_moves=0.0)
    want.update({
        "sphere": dict(local_moves=0.5),
        "gaussian-chain": dict(candidates_per_step=64,
                               max_iterations=4_000_000),
        "cylinders-table": dict(chunk_steps=1024),
        "kholodenko-table": dict(local_moves=0.75,
                                 max_iterations=24_000_000)}[tier])
    assert {k: getattr(cfg, k) for k in want} == want
    assert cfg.show_incomplete
    model = {"sphere": "Sphere", "gaussian-chain": "GaussianChain",
             "cylinders-table": "CylindersIsotropic",
             "kholodenko-table": "Kholodenko"}[tier]
    assert bound.model.name == model and data.count > 0
    assert all(lo < hi < float("inf") for lo, hi in bound.ranges)
    if tier == "cylinders-table":
        assert bound.ranges == ((0.5e-9, 300e-9),)


def test_rep_scaling_workloads():
    """The Sphere headline (the JAX tool's config) and the cylinder row
    of tools/suite.py, at the asked R and N."""
    data, bound, cfg = rep_scaling.tier_workload("sphere", 132, 3000)
    assert bound.model.name == "Sphere" and data.count > 0
    assert (cfg.num_reps, cfg.num_contribs, cfg.candidates_per_step,
            cfg.local_moves, cfg.chunk_steps, cfg.seed) == (
        132, 3000, 128, 0.5, 2048, 2026)
    _, bound, cfg = rep_scaling.tier_workload("cylinders-table", 10, 300)
    assert bound == suite.cylinder_bound()
    assert cfg == suite.cylinder_config(num_reps=10, num_contribs=300)
    with pytest.raises(ValueError, match="unknown tier"):
        rep_scaling.tier_workload("worm", 10, 300)


def test_coldstart_child_reports_a_failure(monkeypatch):
    """run_tier returns a child's rc and the tail of its errors; a child
    without a card fails, naming it."""
    _no_card()
    row = coldstart.run_tier("sphere")
    assert row["rc"] != 0 and row["tier"] == "sphere"
    assert "needs a CUDA card" in row["stderr_tail"]
    assert row["process_s"] > 0
    json.dumps(row)
