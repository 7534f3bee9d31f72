# -*- coding: utf-8 -*-
"""Model bank of the PyTorch port: the registry of the eleven models of
the JAX package (mcsas_tpu/models/__init__.py), in its order, plus
user-plugin loading.

A plugin is a :class:`SASModel` whose ``ff`` and ``volume`` take torch
tensors.  It has no device function of the CUDA chunk kernel, which keys
on the built-in model objects (``ops/mc_kernel.py``): on the card it runs
the plain chunk under ``use_pallas="off"``, or the prefetch kernel K2
when it declares a parameter table (``ff_table_factory``, e.g. made with
``ops.tables.make_lookup``).
"""
from __future__ import annotations

import importlib.util
import logging
import os

from .base import BoundModel, ParamSpec, SASModel
from .chains import GaussianChain, Kholodenko
from .cylinders import (CylindersIsotropic, CylindersIsotropicAspect,
                        CylindersRadiallyIsotropic,
                        CylindersRadiallyIsotropicTilted)
from .ellipsoids import (EllipsoidalCoreShell, EllipsoidsIsotropic,
                         SphericalCoreShell)
from .sphere import LMADenseSphere, Sphere

log = logging.getLogger(__name__)

# canonical ordering follows the reference's model priority list
# (reference: utils/findmodels.py:73-134)
MODELS = (
    Sphere,
    CylindersIsotropic,
    EllipsoidsIsotropic,
    EllipsoidalCoreShell,
    SphericalCoreShell,
    GaussianChain,
    LMADenseSphere,
    Kholodenko,
    CylindersIsotropicAspect,
    CylindersRadiallyIsotropic,
    CylindersRadiallyIsotropicTilted,
)

REGISTRY = {m.name: m for m in MODELS}


def get_model(name: str) -> SASModel:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(REGISTRY)}") from None


def register_model(model: SASModel, overwrite: bool = False):
    if model.name in REGISTRY and not overwrite:
        raise ValueError(f"model {model.name!r} already registered")
    REGISTRY[model.name] = model


def load_model_file(path: str) -> list:
    """Imports a user-provided .py file and registers every SASModel found
    at its module top level (drop-in model capability; reference feature:
    gui/mainwindow.py:95-97)."""
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        f"mcsas_tpu_torch.user.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    found = [v for v in vars(mod).values() if isinstance(v, SASModel)]
    for m in found:
        register_model(m, overwrite=True)
    return found


# the reference's startup ordering: default models first, in this order
# (reference FindModels._priorityModels: utils/findmodels.py:80-89)
_PRIORITY = ("Sphere", "LMADenseSphere", "EllipsoidsIsotropic",
             "CylindersIsotropic", "SphericalCoreShell",
             "EllipsoidalCoreShell", "GaussianChain", "Kholodenko")


def load_model_dir(path: str, recursive: bool = True) -> list:
    """Scans a directory tree for .py files defining SASModels, registers
    each, and returns them priority-ordered — the reference's FindModels
    startup discovery (utils/findmodels.py:73-186: recursive walk, skip
    ``__init__``/private files, import candidates, reorder with the
    default-model priority list first).  Files that fail to import are
    skipped with a warning, like the reference's "Could not load" path
    (findmodels.py:171-175)."""
    found = []
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        for fn in sorted(files):
            if not fn.endswith(".py") or fn.startswith(("_", ".")):
                continue
            fpath = os.path.join(root, fn)
            try:
                found.extend(load_model_file(fpath))
            except Exception as exc:   # mirror reference warn-and-skip
                log.warning("could not load model file %r: %s",
                            fpath, exc)
        if not recursive:
            break
    prio = {n: i for i, n in enumerate(_PRIORITY)}
    found.sort(key=lambda m: (prio.get(m.name, len(prio)), m.name))
    return found


__all__ = ["SASModel", "BoundModel", "ParamSpec", "MODELS", "REGISTRY",
           "get_model", "register_model", "load_model_file",
           "load_model_dir", "Sphere", "LMADenseSphere", "GaussianChain",
           "Kholodenko", "SphericalCoreShell", "EllipsoidsIsotropic",
           "EllipsoidalCoreShell", "CylindersIsotropic",
           "CylindersIsotropicAspect", "CylindersRadiallyIsotropic",
           "CylindersRadiallyIsotropicTilted"]
