# -*- coding: utf-8 -*-
"""PyTorch port: the kernel-library layer (ops/cuda_lib.py) on the CPU.
Its libraries are csrc/'s sources, each declared by a wrapper and none
named by the engine or the post pass; every shared header is in every
build hash; an entry's functions are typed and its struct's size checked
against the library at its first call, and a failed call raises with the
library's CUDA error string (a stand-in library answers for the card).
The libraries themselves build, load and launch on the card
(``chip_smoke.py`` phase 2, ``tests/test_torch_cuda.py``)."""
import ast
import ctypes
import pathlib
import shutil
import types

import pytest

torch = pytest.importorskip("torch")

from mcsas_tpu_torch.ops import (bank_route, cuda_lib,  # noqa: E402
                                 mc_kernel)

PORT = pathlib.Path(mc_kernel.__file__).resolve().parent.parent


def _imported_names(path: pathlib.Path) -> set:
    """Every module and name an import statement of *path* names."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
            names.update(a.name for a in node.names)
    return names


def test_libraries_are_the_sources_and_core_and_post_name_no_bank():
    """The layer's libraries are csrc/*.cu, each declared by a wrapper's
    entries (the MC chunk kernels' and the route's bank kernels'); no
    module under core/ or post/ imports a bank wrapper."""
    want = tuple(sorted(p.stem for p in cuda_lib.CSRC.glob("*.cu")))
    assert cuda_lib.libraries() == want
    entries = [v for module in (mc_kernel, *bank_route.KERNELS)
               for v in vars(module).values()
               if isinstance(v, cuda_lib.Entry)]
    assert sorted({e.library for e in entries}) == list(want)
    wrappers = {k.__name__.rsplit(".", 1)[1] for k in bank_route.KERNELS}
    assert wrappers == {"cyl_bank", "kho_bank"}
    for path in [*PORT.glob("core/*.py"), *PORT.glob("post/*.py")]:
        names = {n.rsplit(".", 1)[-1] for n in _imported_names(path)}
        assert not names & wrappers, path


def test_every_header_is_in_every_build_hash(tmp_path):
    """A library's build path changes with its own source and with every
    header in csrc/, and with no other library's source."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, csrc)
    with cuda_lib.sources(csrc, tmp_path / "build"):
        names = cuda_lib.libraries()
        paths = {n: cuda_lib.library_path(n) for n in names}
        assert all(p.parent == tmp_path / "build" for p in paths.values())
        for header in sorted(csrc.glob("*.cuh")):
            header.write_text(header.read_text() + "\n")
            now = {n: cuda_lib.library_path(n) for n in names}
            assert all(now[n] != paths[n] for n in names), header.name
            paths = now
        source = csrc / f"{names[0]}.cu"
        source.write_text(source.read_text() + "\n")
        now = {n: cuda_lib.library_path(n) for n in names}
        assert [n for n in names if now[n] != paths[n]] == [names[0]]
    assert cuda_lib.library_path(names[0]).parent == cuda_lib.BUILD_DIR


class _Fn:
    """A stand-in C function: ctypes' attributes, a Python body."""
    def __init__(self, body):
        self.body, self.argtypes, self.restype = body, None, None

    def __call__(self, *args):
        return self.body(*args)


class _Library:
    """A stand-in library of one entry ``probe`` whose struct holds
    *size* bytes and whose calls return *rc*."""
    def __init__(self, size, rc):
        self.calls = []

        def shape(prm, out):
            out[0], out[1] = 32, 7
            return rc
        self.lib_error_string = _Fn(lambda code: b"no kernel image")
        self.probe_launch = _Fn(lambda prm, stream: self.calls.append(
            "launch") or rc)
        self.probe_shape = _Fn(shape)
        self.probe_params_size = _Fn(lambda: self.calls.append("size")
                                     or size)


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int32), ("x", ctypes.c_double)]


@pytest.mark.parametrize("size,rc,error", [
    (16, 0, None), (12, 0, "layout mismatch: C 12 bytes, ctypes 16"),
    (16, 98, "failed: CUDA error 98 \\(no kernel image\\)")])
def test_an_entry_is_checked_at_its_first_call(size, rc, error,
                                               monkeypatch, tmp_path):
    """The first call of an entry types its functions and checks its
    struct's size against ``<entry>_params_size``, once a load; a struct
    of another size raises, and so does a non-zero return of a launch or
    a shape query, naming the entry and the library's error string; a
    shape query returns the entry's shape names."""
    libs = []

    def build(names):
        return {n: cuda_lib.KernelBuild(path=tmp_path / n, seconds=0.0,
                                        log="") for n in names}

    def cdll(path):
        libs.append(_Library(size, rc))
        return libs[-1]

    monkeypatch.setattr(cuda_lib, "build_libraries", build)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    entry = cuda_lib.Entry("probe", _Params, ("threads", "blocks"),
                           library="lib")
    calls = (lambda: cuda_lib.shape(entry, _Params()),
             lambda: cuda_lib.launch(entry, _Params(), "cuda"))
    for _ in range(2):                  # two loads, one after the other
        with cuda_lib.sources(tmp_path, tmp_path):
            for what, call in zip(("shape", "launch"), calls):
                if error:
                    with pytest.raises(RuntimeError,
                                       match=f"probe {what} {error}"
                                       if rc else error):
                        call()
                else:
                    assert call() == ({"threads": 32, "blocks": 7}
                                      if what == "shape" else None)
    assert len(libs) == 2
    for lib in libs:
        assert lib.probe_shape.restype is ctypes.c_int
        assert lib.probe_launch.argtypes[-1] is ctypes.c_void_p
        assert lib.probe_shape.argtypes[-1] is ctypes.POINTER(ctypes.c_int)
        assert lib.lib_error_string.restype is ctypes.c_char_p
        # the size is checked at each call until it matches, then once a
        # load; a launch happens only once it matched
        assert lib.calls == (["size", "size"] if size != 16
                             else ["size", "launch"])
