# -*- coding: utf-8 -*-
"""ctypes binding of the native C++ ASCII tokenizer
(``mcsas_tpu_torch/native/fastparse.cpp``, this package's own copy of the
JAX package's).

The library is built at first use by the host C++ compiler (``$CXX``, else
``g++``) into ``build/native/``, keyed by a hash of the source and the
flags as the CUDA kernels are keyed (``ops/mc_kernel.py``), and loaded
once per process.  A build or a load that fails raises with the
compiler's output: unlike the JAX package (mcsas_tpu/io/native.py:31-57)
nothing falls back to the Python parser behind the caller's back; the
caller asks for the Python parser with ``use_native=False`` or
``MCSAS_TPU_NO_NATIVE=1`` (``io/ascii.py``).  The Python parser stays the
semantics oracle: the tests hold both byte for byte on every dialect.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native" \
    / "fastparse.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"the native ASCII parser needs a C++ compiler: "
                           f"{cxx!r} is not on PATH (set CXX, or load with "
                           f"use_native=False / MCSAS_TPU_NO_NATIVE=1)")
    return found


def library_path() -> pathlib.Path:
    """build/native/fastparse_<hash>.so, the hash covering the source and
    the flags."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"fastparse_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compiles the parser into build/native/ unless its build of the
    present source is there; returns the library's path.  Raises with the
    compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_compiler(), *_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native ASCII parser "
                           f"({_SRC.name}) failed with exit code "
                           f"{proc.returncode}:\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, path)
    return path


def _load():
    """The loaded library, built at the first call of the process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.mc_parse.restype = ctypes.c_void_p
        lib.mc_parse.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                 ctypes.c_long]
        lib.mc_rows.restype = ctypes.c_long
        lib.mc_rows.argtypes = [ctypes.c_void_p]
        lib.mc_cols.restype = ctypes.c_long
        lib.mc_cols.argtypes = [ctypes.c_void_p]
        lib.mc_copy.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_double)]
        lib.mc_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def parse_text(text: str, skip_lines: int = 0):
    """Parses an ASCII table natively; returns a float64 (rows, cols)
    array, or None when the text holds no data table (a result, not a
    failure: the Python parser then raises FileReadError)."""
    lib = _load()
    raw = text.encode("utf-8", "replace")
    handle = lib.mc_parse(raw, len(raw), skip_lines)
    try:
        rows, cols = lib.mc_rows(handle), lib.mc_cols(handle)
        if rows <= 0 or cols <= 0:
            return None
        out = np.empty(rows * cols, dtype=np.float64)
        lib.mc_copy(handle, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)))
        return out.reshape(rows, cols)
    finally:
        lib.mc_free(handle)
