"""On the card (marker ``cuda``; skips without one): each cell at its own
size, three seeds: the program passes its checks and the control fails
them; and one run of the harness as the check runs it."""
import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT
from benchmark import run

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.cache_env()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    piece = run.load_cell(cell)
    for seed in (2 ** 31 + 31, 2 ** 31 + 32, 2 ** 31 + 33):
        rec = run.run_cell(piece, seed, 5.0, control=True,
                           t_start=time.perf_counter())
        assert run.passes(rec["checks"], piece["limits"]), rec["checks"]
        assert not run.passes(rec["control"], piece["limits"]), \
            rec["control"]


@pytest.mark.cuda
def test_one_run_as_the_check_runs_it(card):
    p = subprocess.run([sys.executable, "-m", "benchmark.run",
                        "--workload", CELLS[0], "--seed", str(2 ** 31 + 34),
                        "--seconds", "3", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
