# -*- coding: utf-8 -*-
"""Tracing / profiling / numerical-safety helpers (the JAX package's
mcsas_tpu/utils/profiling.py on torch.profiler), and the port's one span
and counter recorder.

* :func:`span` marks a phase of the program and :func:`count` adds to a
  named counter; both do nothing unless a :func:`recording` scope is
  open, which yields the :class:`Recorder` that keeps them in memory.
  Spans are stamped on the clock of torch.profiler's events (Unix-epoch
  nanoseconds, ``time.time_ns``), and while a profiler runs each span
  also opens a ``record_function`` of its name, so a trace shows the
  program's spans on the kernels' timeline;
* :func:`trace` captures the enclosed scope with ``torch.profiler`` (CPU
  activity, plus the card's kernels where CUDA is available) and writes a
  Chrome trace into a directory;
* :func:`annotate` marks a host-side phase inside a trace;
* :func:`debug_guards` makes the MC engine check, once a chunk, the χ²,
  ft, scale and background it reads then anyway, and raise
  ``FloatingPointError`` at the first NaN (or inf) instead of counting the
  repetition as stuck — the counterpart of JAX's ``jax_debug_nans`` /
  ``jax_debug_infs`` flags for this package's engine;
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


# ------------------------------------------------------ spans and counters

# the Recorder of the innermost open recording() scope, else None: the one
# check span() and count() make
_RECORDER = None


class _NoSpan:
    """The shared context :func:`span` returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class Recorder:
    """The spans and counters of one :func:`recording` scope, in memory.

    ``spans`` holds one plain tuple ``(name, start_ns, end_ns,
    parent_index, fit_index)`` per span in the order they opened: times
    in Unix-epoch nanoseconds (the clock of torch.profiler's events),
    ``parent_index`` the index of the span that holds it (-1 for none),
    ``fit_index`` the index of the fit it belongs to (spans opened with
    ``fit=True`` number the fits from 0; -1 outside any), ``end_ns`` -1
    while the span is open.  ``counters`` maps a counter's name to its
    sum."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.n_fits = 0
        self._open = []         # indices of the open spans, innermost last

    def report(self) -> dict:
        """{name: {"count", "total_s", "self_s"}} of the closed spans,
        largest total first; a span's self time is its duration less its
        direct children's."""
        child = [0] * len(self.spans)
        for _, start, end, parent, _ in self.spans:
            if parent >= 0 and end >= 0:
                child[parent] += end - start
        out = {}
        for (name, start, end, _, _), inner in zip(self.spans, child):
            if end < 0:
                continue
            row = out.setdefault(name, {"count": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            row["count"] += 1
            row["total_s"] += (end - start) * 1e-9
            row["self_s"] += (end - start - inner) * 1e-9
        return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_s"]))


class _Span:
    """One span of a :class:`Recorder` (see :func:`span`)."""
    __slots__ = ("rec", "name", "fit", "index", "rf")

    def __init__(self, rec: Recorder, name: str, fit: bool):
        self.rec, self.name, self.fit = rec, name, fit

    def __enter__(self):
        rec = self.rec
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            # opened before the span's clock reads, closed after them: the
            # profiler's event holds the span
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        parent = rec._open[-1] if rec._open else -1
        if self.fit:
            fit = rec.n_fits
            rec.n_fits += 1
        else:
            fit = rec.spans[parent][4] if parent >= 0 else -1
        self.index = len(rec.spans)
        rec._open.append(self.index)
        rec.spans.append((self.name, time.time_ns(), -1, parent, fit))
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        name, start, _, parent, fit = rec.spans[self.index]
        rec.spans[self.index] = (name, start, end, parent, fit)
        rec._open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, fit: bool = False):
    """Context marking a phase *name* of the program in the open
    :func:`recording` scope; with *fit* the span starts the next fit, whose
    index its child spans carry.  Outside a recording scope it returns one
    shared no-op context: no allocation, no clock read.  A span never
    synchronizes the card."""
    if _RECORDER is None:
        return _NO_SPAN
    return _Span(_RECORDER, name, fit)


def count(name: str, n: int = 1) -> None:
    """Adds *n* to counter *name* of the open :func:`recording` scope; a
    no-op outside one."""
    if _RECORDER is not None:
        c = _RECORDER.counters
        c[name] = c.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Scope in which :func:`span` and :func:`count` record; yields its
    :class:`Recorder`.  A scope inside another records into its own
    Recorder and restores the outer one on exit."""
    global _RECORDER
    prev, rec = _RECORDER, Recorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = prev


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
