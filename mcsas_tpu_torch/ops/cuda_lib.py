# -*- coding: utf-8 -*-
"""The port's CUDA kernel libraries: build, load and launch.

Every ``csrc/<name>.cu`` is one library (:func:`libraries`), built with
plain nvcc for ``sm_90a`` into ``build/kernels/<name>_<hash>.so`` at first
use (the hash covers its source, every ``csrc/*.cuh`` and the flags; one
nvcc a library, all started together) and loaded with ctypes once per
process.  A C entry of a library (``<entry>_launch``, ``_shape`` and
``_params_size``) is declared by the module that wraps its kernel, as an
:class:`Entry`; :func:`launch` and :func:`shape` call it.  This module
knows no kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from ..utils import profiling

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the sources and the build directory in use (sources() swaps them)
_csrc, _build_dir = CSRC, BUILD_DIR
_LOADED: dict = {}            # library -> ctypes.CDLL, loaded once
_TYPED: dict = {}             # entry -> the library it was typed for


@dataclass(frozen=True)
class KernelBuild:
    path: pathlib.Path
    seconds: float          # nvcc wall time; 0.0 when the library existed
    log: str                # nvcc/ptxas output (registers, spills)


@dataclass(frozen=True)
class Entry:
    """The C entry *name* of ``csrc/<library>.cu`` (*library* defaults
    to *name*): it takes *params*, the ctypes mirror of its C struct, and
    *n_extra* ints after it; ``<name>_shape`` reports the values *shape*
    names."""
    name: str
    params: type
    shape: tuple
    library: str = ""
    n_extra: int = 0

    def __post_init__(self):
        if not self.library:
            object.__setattr__(self, "library", self.name)


def libraries() -> tuple:
    """The kernel libraries, by name: every ``csrc/*.cu``."""
    return tuple(sorted(p.stem for p in _csrc.glob("*.cu")))


def _nvcc() -> str:
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    found = shutil.which("nvcc") or shutil.which(str(home / "bin" / "nvcc"))
    if found:
        return found
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA "
                       "kernels")


def library_path(name: str) -> pathlib.Path:
    """build/kernels/<name>_<hash>.so, the hash covering the library's
    source, every shared header and the flags."""
    digest = hashlib.sha256()
    for path in (_csrc / f"{name}.cu", *sorted(_csrc.glob("*.cuh"))):
        digest.update(path.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return _build_dir / f"{name}_{digest.hexdigest()[:16]}.so"


def build_libraries(names=None) -> dict:
    """Compiles csrc/<name>.cu into build/kernels/ for each name (every
    library where *names* is None) missing there, one nvcc process per
    source, all started together; reuses existing builds.  Returns
    {name: KernelBuild}.  Waits for every nvcc it started, then raises
    with nvcc's output if any build failed."""
    with profiling.span("ops.mc_kernel.build"):
        builds, running = {}, {}
        for name in libraries() if names is None else names:
            path = library_path(name)
            if path.exists():
                builds[name] = KernelBuild(path=path, seconds=0.0, log="")
                continue
            _build_dir.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.Popen(
                [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                 str(_csrc / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            running[name] = (path, tmp, time.perf_counter(), proc)
        failed = []
        for name, (path, tmp, t0, proc) in running.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed with exit code {proc.returncode} "
                              f"building csrc/{name}.cu:\n{err}{out}")
                continue
            os.replace(tmp, path)
            builds[name] = KernelBuild(path=path,
                                       seconds=time.perf_counter() - t0,
                                       log=err + out)
        if failed:
            raise RuntimeError("\n".join(failed))
        return builds


def load(name: str):
    """The loaded library *name*, resolved once per process: the first
    call builds it if build/kernels/ lacks the build of the present
    sources (:func:`build_libraries`) and loads it; later calls neither
    hash nor stat the sources."""
    lib = _LOADED.get(name)
    if lib is None:
        build = build_libraries((name,))[name]
        with profiling.span("ops.mc_kernel.load"):
            lib = ctypes.CDLL(str(build.path))
            err_fn = getattr(lib, f"{name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def _call(entry: Entry, what: str, *args):
    """Calls ``<entry>_<what>`` of the entry's library, the entry's
    functions typed and its struct's size checked at its first call
    after a load; raises on a CUDA error code."""
    lib = load(entry.library)
    if _TYPED.get(entry.name) is not lib:
        extra = [ctypes.c_int] * entry.n_extra
        tails = {"launch": ctypes.c_void_p,
                 "shape": ctypes.POINTER(ctypes.c_int)}
        for name, tail in tails.items():
            fn = getattr(lib, f"{entry.name}_{name}")
            fn.argtypes = [ctypes.c_void_p] + extra + [tail]
            fn.restype = ctypes.c_int
        size_fn = getattr(lib, f"{entry.name}_params_size")
        size_fn.argtypes, size_fn.restype = [], ctypes.c_int
        have, want = size_fn(), ctypes.sizeof(entry.params)
        if have != want:
            raise RuntimeError(f"{entry.name} parameter layout mismatch: C "
                               f"{have} bytes, ctypes {want} bytes")
        _TYPED[entry.name] = lib
    rc = getattr(lib, f"{entry.name}_{what}")(*args)
    if rc != 0:
        msg = getattr(lib, f"{entry.library}_error_string")(rc).decode()
        raise RuntimeError(f"{entry.name} {what} failed: CUDA error {rc} "
                           f"({msg})")


def launch(entry: Entry, prm, device: torch.device, *extra):
    """Launches the kernel of *entry* with *prm* (and the ints *extra*)
    on the current stream of *device*; raises on a refused launch."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _call(entry, "launch", ctypes.byref(prm), *extra,
          ctypes.c_void_p(stream))


def shape(entry: Entry, prm, *extra) -> dict:
    """The launch shape of the kernel that *entry* would launch for *prm*
    (and the ints *extra*: a K3 rung), by the names of ``entry.shape``."""
    out = (ctypes.c_int * len(entry.shape))()
    _call(entry, "shape", ctypes.byref(prm), *extra, out)
    return dict(zip(entry.shape, out))


def ptr(t):
    """The address *t* (a tensor, or None) passes to a kernel."""
    return t.data_ptr() if t is not None else None


def require(name: str, t: torch.Tensor, dtype, shape, device):
    """Raises, naming *name*, unless *t* is a contiguous *dtype* tensor
    of *shape* on *device*: what a kernel reads through its pointer."""
    if (t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}" + ("" if t.is_contiguous()
                                          else ", not contiguous"))


def device_index(dev: torch.device) -> int:
    """The CUDA ordinal of *dev* (the current device's for ``cuda``)."""
    return dev.index if dev.index is not None else torch.cuda.current_device()


@contextmanager
def sources(csrc, build_dir):
    """Builds and loads every library from *csrc* into *build_dir* for
    the duration (a variant of csrc/, ``tools/k1_sweep.py``); the loaded
    libraries are forgotten on entry and on exit."""
    global _csrc, _build_dir
    saved = _csrc, _build_dir
    _csrc, _build_dir = pathlib.Path(csrc), pathlib.Path(build_dir)
    _LOADED.clear()
    try:
        yield
    finally:
        _csrc, _build_dir = saved
        _LOADED.clear()
