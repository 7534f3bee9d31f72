# -*- coding: utf-8 -*-
"""PyTorch port: the post pass's bank kernels together (the route
ops/bank_route.py, the wrappers ops/cyl_bank.py and ops/kho_bank.py, their
shared code ops/bank_common.py) on the CPU.  Which bindings and data take
each kernel's route, and that only a CUDA device launches one; what each
wrapper refuses; each parameter struct against its C source; the CPU post
pass, which keeps the eager bank (the kernels' plain version) and needs
no library; and ``_bank_f64`` following the route.  Each kernel's own
arithmetic is tested in ``tests/test_torch_cyl_bank.py`` and
``tests/test_torch_kho_bank.py``."""
import ctypes
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bank_cases import (CYL_Q_NM, RADII, WORM_Q_NM, contribs,  # noqa: E402
                        cylinders, frames, worm)
from mcsas_tpu_torch.config import McSASConfig  # noqa: E402
from mcsas_tpu_torch.models import get_model  # noqa: E402
from mcsas_tpu_torch.ops import (bank_route, cuda_lib, cyl_bank,  # noqa: E402
                                 kho_bank)
from mcsas_tpu_torch.post import histogram  # noqa: E402
from mcsas_tpu_torch.tools import suite  # noqa: E402
from mcsas_tpu_torch.utils import profiling  # noqa: E402

BANKS = {"cyl_bank": cyl_bank, "kho_bank": kho_bank}
_BIND = {"cyl_bank": cylinders, "kho_bank": worm}
_Q_NM = {"cyl_bank": CYL_Q_NM, "kho_bank": WORM_Q_NM}


def _data(bank, smear=False):
    return frames(_Q_NM[bank], smear)


# ------------------------------------------------------------------ route

# the models of each kernel's route cases that neither kernel computes
_OTHERS = {"cyl_bank": {"sphere": "Sphere",
                        "cylinders-aspect": "CylindersIsotropicAspect",
                        "ellipsoids": "EllipsoidsIsotropic"},
           "kho_bank": {"sphere": "Sphere", "gaussian-chain": "GaussianChain",
                        "cylinders": "CylindersIsotropic"}}


def _route_case(bank, case):
    """(binding, data) of one of *bank*'s route cases."""
    if case in _OTHERS[bank]:
        return get_model(_OTHERS[bank][case]).bind(), _data(bank, True)
    bound = {"cylinders-length": lambda: cylinders(
                 active=("radius", "length"),
                 active_ranges=dict(RADII, length=(1e-9, 1e-6)),
                 fixed={"useAspect": 0.0}),
             "cylinders-own-table": lambda: suite.unblendable_cylinder(
                 "opaque-lookup"),
             "worm-fixed-radius": lambda: worm(
                 active=("lenKuhn", "lenContour"), fixed={"radius": 2e-9}),
             }.get(case, _BIND[bank])()
    d = _data(bank, smear=case.endswith("-slit"))
    if case.endswith("-2d"):
        d = dataclasses.replace(d, psi=np.linspace(0.0, 1.0, d.count))
    return bound, d


@pytest.mark.parametrize("bank,case,takes", [
    ("cyl_bank", "cylinders", True), ("cyl_bank", "cylinders-slit", True),
    ("cyl_bank", "cylinders-length", True),
    ("cyl_bank", "cylinders-own-table", True),
    ("cyl_bank", "sphere", False), ("cyl_bank", "cylinders-aspect", False),
    ("cyl_bank", "ellipsoids", False), ("cyl_bank", "cylinders-2d", False),
    ("kho_bank", "worm", True), ("kho_bank", "worm-slit", True),
    ("kho_bank", "worm-fixed-radius", True), ("kho_bank", "worm-2d", False),
    ("kho_bank", "sphere", False), ("kho_bank", "gaussian-chain", False),
    ("kho_bank", "cylinders", False)])
def test_route_follows_the_binding_and_the_data(bank, case, takes):
    """Each kernel's route: a model whose form factor is the kernel's (the
    cylinders' orientation average, the built-in or a copy with a table of
    its own, either useAspect; the worm's, whatever is active) on 1D data,
    smeared or not; not another model, not 2D data.  Only a CUDA device
    launches it, and no bank takes both kernels' routes."""
    bound, d = _route_case(bank, case)
    kernel = BANKS[bank]
    assert kernel.applies(bound, d) is takes
    assert (bank_route.kernel_for(bound, d, "cuda") is kernel) is takes
    assert bank_route.kernel_for(bound, d, torch.device("cpu")) is None
    others = [k for k in bank_route.KERNELS if k is not kernel]
    assert not (takes and any(k.applies(bound, d) for k in others))


# ------------------------------------------------------------- the wrappers

def _inputs(bank, smear=False):
    bound = _BIND[bank]()
    rset = torch.as_tensor(contribs(bound, 2, 5))
    return BANKS[bank].bank_inputs(bound, _data(bank, smear=smear),
                                   4.0 / 3.0, rset)


# each wrapper's own faults: the field a wrong dtype, a short shape and a
# short constant array break
_OWN = {"cyl_bank": {"dtype": "radius", "shape": "length", "nodes": "s"},
        "kho_bank": {"dtype": "kuhn", "shape": "x", "rule": "rule"}}


def _fault(bank, kind):
    inp = _inputs(bank, smear=kind in ("no smear_w", "contiguity"))
    field = _OWN[bank].get(kind)
    if kind == "dtype":
        return inp._replace(**{field: getattr(inp, field).float()}), field
    if field is not None:
        short = getattr(inp, field)[:-1].clone()
        return inp._replace(**{field: short}), f"{field}:"
    if kind == "contiguity":
        grid = inp.grid.t().contiguous().t()
        return inp._replace(grid=grid), "not contiguous"
    if kind == "device":
        return inp._replace(weight=inp.weight.to("meta")), "weight"
    if kind == "no smear_w":
        return inp._replace(smear_w=None), "smear_w"
    if kind == "grid":
        return inp._replace(grid=inp.grid.reshape(-1)), "grid"
    return inp, "CUDA device"                  # all well, but on the CPU


@pytest.mark.parametrize("bank,kind", [
    (bank, kind) for bank, third in (("cyl_bank", "nodes"),
                                     ("kho_bank", "rule"))
    for kind in ("cpu", "dtype", "shape", "contiguity", "device", third,
                 "no smear_w", "grid")])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bank, kind,
                                                         monkeypatch):
    """Each wrapper checks device, dtype, shape and contiguity before it
    allocates or launches: each fault raises naming it, nothing launches
    and the count stays."""
    def refuse(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(cuda_lib, "launch", refuse)
    monkeypatch.setattr(cuda_lib, "shape", refuse)
    kernel = BANKS[bank]
    inp, names = _fault(bank, kind)
    before = kernel.run.launches
    with pytest.raises(ValueError, match=names):
        kernel.run(inp)
    with pytest.raises(ValueError, match=names):
        kernel.launch_shape(inp)
    assert kernel.run.launches == before


_C_TYPES = {"const double*": ctypes.c_void_p, "double*": ctypes.c_void_p,
            "double": ctypes.c_double, "int32_t": ctypes.c_int32}


@pytest.mark.parametrize("bank,shape", [
    ("cyl_bank", ("group", "threads", "blocks", "registers",
                  "local_bytes")),
    ("kho_bank", ("threads", "blocks", "smem_bytes", "registers",
                  "local_bytes"))])
def test_params_struct_mirrors_the_c_source(bank, shape):
    """Each wrapper's parameter struct has its C struct's fields in
    csrc/<bank>.cu's order and types (the layer also checks the struct's
    size against the library's); its entry is csrc/<bank>.cu's, reports
    the shape's five values, and the shared header it includes is in its
    build hash."""
    kernel = BANKS[bank]
    src = (cuda_lib.CSRC / f"{bank}.cu").read_text()
    name = kernel.ENTRY.params.__name__.lstrip("_")
    body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
    fields = re.findall(r"^\s*(const double\*|double\*|double|int32_t)\s+"
                        r"(\w+);", body, re.M)
    assert [(n, _C_TYPES[t]) for t, n in fields] == list(
        kernel.ENTRY.params._fields_)
    assert kernel.ENTRY == cuda_lib.Entry(bank, kernel.ENTRY.params, shape)
    assert kernel.ENTRY.library == bank and bank in cuda_lib.libraries()
    assert '#include "bank_common.cuh"' in src
    assert (cuda_lib.CSRC / "bank_common.cuh").exists()


# --------------------------------------------------------- the CPU's bank

@pytest.mark.parametrize("bank", ["cyl_bank", "kho_bank"])
@pytest.mark.parametrize("smear", [False, True])
def test_cpu_post_pass_keeps_the_eager_bank(bank, smear, monkeypatch):
    """On the CPU each kernel's bank is the eager chain, unchanged and
    without a library: no kernel call, no build or load, and the bank is
    the model's ff²·w (through the slit: (ff²(locs) @ smear_w)·w) bit for
    bit; the post pass counts one eager bank."""
    def refuse(*args):
        raise AssertionError("the kernel route on the CPU")

    for name in ("launch", "shape", "build_libraries", "load"):
        monkeypatch.setattr(cuda_lib, name, refuse)
    monkeypatch.setattr(BANKS[bank], "run", refuse)
    bound, d = _BIND[bank](), _data(bank, smear=smear)
    comp2 = 4.0 / 3.0
    n = 5 if bank == "cyl_bank" else 3
    c = contribs(bound, 2, n)
    rset = torch.as_tensor(c)
    got = histogram._bank_f64(bound, d, comp2, rset)
    part = rset.reshape(-1, rset.shape[-1])
    grid = torch.as_tensor(d.locs if smear else d.q)
    pd = bound.pdict(part[:, None, None, :] if smear else part[:, None, :])
    ff = bound.model.ff(grid, pd)
    it = (ff * ff) @ torch.as_tensor(d.smear_w) if smear else ff * ff
    w = bound.model.volume(bound.pdict(part[:, None, :])) ** comp2
    assert torch.equal(got, (it * w).reshape(got.shape))
    with profiling.recording() as rec:
        out = histogram._post_pass_f64(bound, d, McSASConfig(
            num_contribs=n, num_reps=2), c)
    assert all(np.isfinite(v).all() for v in out)
    assert rec.counters.get("post.bank.eager") == 1
    assert "post.bank.kernel" not in rec.counters


@pytest.mark.parametrize("bank", ["cyl_bank", "kho_bank"])
@pytest.mark.parametrize("launches", [False, True])
def test_bank_follows_the_route(bank, launches, monkeypatch):
    """_bank_f64 launches a bank kernel exactly where the route names it,
    that kernel with the wrapper's inputs, and takes the eager bank
    everywhere else: the route is decided in one place.  The launch is
    rehearsed on CPU tensors, the device check and the C call
    replaced."""
    calls = []
    kernel = BANKS[bank]
    monkeypatch.setattr(bank_route, "kernel_for",
                        lambda bound, data, device:
                        kernel if launches else None)
    monkeypatch.setattr(kernel, "_check", lambda inp: None)
    monkeypatch.setattr(cuda_lib, "device_index", lambda dev: 0)
    monkeypatch.setattr(cuda_lib, "launch", lambda entry, prm, dev:
                        calls.append((entry, prm)))
    bound, d = _BIND[bank](), _data(bank)
    rset = torch.as_tensor(contribs(bound, 2, 5))
    before = kernel.run.launches
    got = histogram._bank_f64(bound, d, 4.0 / 3.0, rset)
    assert tuple(got.shape) == (2, 5, d.count)
    assert len(calls) == int(launches)
    assert kernel.run.launches == before + int(launches)
    if launches:
        (entry, prm), = calls
        assert entry is kernel.ENTRY and prm.out == got.data_ptr()
        assert (prm.n_contribs, prm.nq, prm.n_off) == (10, d.count, 1)
    else:
        assert bool((got > 0).all())
