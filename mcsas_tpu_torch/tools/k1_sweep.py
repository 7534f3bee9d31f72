# -*- coding: utf-8 -*-
"""K1's time per step against its launch shape.

K1 (csrc/mc_chunk.cuh) runs a group of MC_K1_GROUP lanes per candidate in
blocks of at most MC_BLOCK_THREADS threads; at 1024 threads a thread has
at most 64 registers, and the models' set-up spills a few.  This sweep
builds K1 once per thread cap from a copy of csrc/ with that cap (into
build/kernels/sweep/), and times each model's K1 at each candidate count
K on the probe's headline-shaped engine (tools/kern_probe.py: R=10,
N=300, Nq=100, local moves 0.5, convergence criterion 0): one Philox
chunk of CHUNK steps from one state, LAUNCHES launches after a warm-up,
CUDA events around them.  All caps must leave the same state, bit for
bit.  It prints one JSON line per (cap, model, K)
``{"threads_cap", "model", "k", "threads", "registers", "local_bytes",
"us_per_step"}``.  Small K shows the latency of one candidate's step;
the growth from K=64 to 128 the work the SM issues.  Needs a card:

    python -m mcsas_tpu_torch.tools.k1_sweep [--caps 1024 512]
        [--candidates 8 16 32 64 128 256] [--model NAME ...]
"""
from __future__ import annotations

import argparse
import json
import shutil
from contextlib import contextmanager

import torch

from ..core.engine import McSASEngine
from ..ops import cuda_lib, mc_kernel
from . import kern_probe

CAPS = (1024, 512)
CANDIDATES = (8, 16, 32, 64, 128, 256)
LAUNCHES = 3
_DEFINE = "#define MC_BLOCK_THREADS "


@contextmanager
def _sources(cap: int):
    """The kernel libraries built and loaded from a copy of csrc/ whose
    block holds at most *cap* threads, for the duration."""
    root = cuda_lib.BUILD_DIR / "sweep" / str(cap)
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC, csrc)
    header = csrc / "mc_chunk.cuh"
    text = header.read_text()
    if text.count(_DEFINE) != 1:
        raise RuntimeError(f"{_DEFINE.strip()} not found once in "
                           f"{header}")
    head, tail = text.split(_DEFINE)
    header.write_text(head + _DEFINE + str(cap) + tail[tail.index("\n"):])
    with cuda_lib.sources(csrc, root):
        yield


def time_k1(eng: McSASEngine, state0, launches: int = LAUNCHES) -> tuple:
    """(mean ms of one CHUNK-step Philox launch of K1 from *state0*, the
    state after one launch)."""
    work = state0.clone()

    def launch():
        mc_kernel.run_chunk(work.copy_(state0), 0, eng.consts, eng.spec,
                            seed=kern_probe.SEED, n_steps=kern_probe.CHUNK)

    launch()
    torch.cuda.synchronize()
    after = work.clone()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        launch()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / launches, after


def run(caps=CAPS, candidates=CANDIDATES, models=None,
        launches: int = LAUNCHES):
    """Times K1 at every cap, model and K; returns the result dicts and
    prints each as a JSON line."""
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep measures the CUDA kernel: "
                           "torch.cuda.is_available() is False")
    for cap in caps:                 # build every cap before timing any
        with _sources(cap):
            cuda_lib.build_libraries(("mc_chunk",))
    names = models or [m.name for m in mc_kernel.K1_MODELS]
    out, first = [], {}
    for name in names:
        base = kern_probe.probe_engine(name)
        for k in candidates:
            eng = McSASEngine(base.data, base.bound,
                              base.cfg.replace(candidates_per_step=k),
                              device="cuda")
            eng.gen.manual_seed(1)
            state0 = eng._init_batch()
            for cap in caps:
                with _sources(cap):
                    ms, after = time_k1(eng, state0, launches)
                    shape = mc_kernel.launch_shape(state0, eng.consts,
                                                   eng.spec)
                ref = first.setdefault((name, k), after)
                for f in ("rset", "ibank", "ft", "scale", "background",
                          "conval", "n_iter", "n_moves"):
                    if not torch.equal(getattr(ref, f), getattr(after, f)):
                        raise AssertionError(f"{name} K={k}: cap {cap} "
                                             f"differs in {f}")
                rec = {"threads_cap": cap, "model": name, "k": k,
                       "threads": shape["threads"],
                       "registers": shape["registers"],
                       "local_bytes": shape["local_bytes"],
                       "us_per_step": ms * 1e3 / kern_probe.CHUNK}
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--caps", type=int, nargs="+", default=list(CAPS))
    ap.add_argument("--candidates", type=int, nargs="+",
                    default=list(CANDIDATES))
    ap.add_argument("--model", action="append",
                    help="a model name (repeatable); default: every K1 "
                         "model")
    ap.add_argument("--launches", type=int, default=LAUNCHES)
    args = ap.parse_args(argv)
    run(args.caps, args.candidates, args.model, args.launches)


if __name__ == "__main__":
    main()
