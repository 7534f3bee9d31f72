# -*- coding: utf-8 -*-
"""Tracing / profiling / numerical-safety helpers (the JAX package's
mcsas_tpu/utils/profiling.py on torch.profiler).

* :func:`trace` captures the enclosed scope with ``torch.profiler`` (CPU
  activity, plus the card's kernels where CUDA is available) and writes a
  Chrome trace into a directory;
* :func:`annotate` marks a host-side phase inside a trace;
* :func:`debug_guards` makes the MC engine check, once a chunk, the χ²,
  ft, scale and background it reads then anyway, and raise
  ``FloatingPointError`` at the first NaN (or inf) instead of counting the
  repetition as stuck — the counterpart of JAX's ``jax_debug_nans`` /
  ``jax_debug_infs`` flags for this package's engine;
* :class:`Stopwatch` times phases on the host clock;
* :func:`require_card` stops a measuring tool without a card, and
  :func:`card_line` names the card and its power limit beside a number.
"""
from __future__ import annotations

import contextlib
import logging
import os
import subprocess
import time

import torch

log = logging.getLogger(__name__)

# debug_guards' flags, read by the engine at the start of a run
_GUARDS = {"nans": False, "infs": False}


@contextlib.contextmanager
def trace(log_dir):
    """Captures a torch.profiler trace of the enclosed scope and writes it
    as ``trace_<pid>_<n>.json`` (Chrome trace format) into *log_dir*.
    Yields the profiler, whose ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        n = len([f for f in os.listdir(str(log_dir))
                 if f.startswith(f"trace_{os.getpid()}_")])
        path = os.path.join(str(log_dir), f"trace_{os.getpid()}_{n}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)


def annotate(name: str):
    """Named sub-span inside a profiler trace (usable as context)."""
    return torch.profiler.record_function(name)


def guard_flags():
    """``(nans, infs)`` while :func:`debug_guards` checks either, else
    None."""
    if _GUARDS["nans"] or _GUARDS["infs"]:
        return (_GUARDS["nans"], _GUARDS["infs"])
    return None


@contextlib.contextmanager
def debug_guards(nans: bool = True, infs: bool = False):
    """Scope in which the MC engine raises ``FloatingPointError``, naming
    the chunk and the repetition, when χ², ft, scale or background holds
    a NaN (*nans*) or an inf (*infs*) after a chunk.  The checks ride on
    the one read of χ² the host makes a chunk, so they add no
    synchronization.  The previous flags are restored on exit."""
    prev = dict(_GUARDS)
    _GUARDS.update(nans=bool(nans), infs=bool(infs))
    try:
        yield
    finally:
        _GUARDS.update(prev)


class Stopwatch:
    """Wall-clock phase timing with a report, the structured replacement
    for the reference's ad-hoc per-rep ETA logging (mcsas.py:249-262)."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k:>20s}: {v:8.3f}s "
                 f"({100 * v / max(total, 1e-300):4.1f}%)"
                 for k, v in sorted(self.phases.items(),
                                    key=lambda kv: -kv[1])]
        return "\n".join(lines + [f"{'total':>20s}: {total:8.3f}s"])


def require_card(tool: str) -> None:
    """Exits *tool* with an error naming the missing card unless
    ``torch.cuda.is_available()``: a tool that measures the card never
    times the CPU instead."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: needs a CUDA card, and "
                         "torch.cuda.is_available() is False; it measures "
                         "the card and never times the CPU")


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
