# -*- coding: utf-8 -*-
"""Model bank of the PyTorch port: the registry of ported models.

Sphere, LMADenseSphere, GaussianChain, SphericalCoreShell and
CylindersIsotropic are ported so far; the other reference models keep
their names here so that asking for one gives a clear error instead of an
unknown model.
"""
from __future__ import annotations

from .base import BoundModel, ParamSpec, SASModel
from .chains import GaussianChain
from .cylinders import CylindersIsotropic
from .ellipsoids import SphericalCoreShell
from .sphere import LMADenseSphere, Sphere

MODELS = (Sphere, LMADenseSphere, GaussianChain, SphericalCoreShell,
          CylindersIsotropic)

REGISTRY = {m.name: m for m in MODELS}

# reference models that the JAX package has and this package does not yet
_NOT_PORTED = (
    "EllipsoidsIsotropic", "EllipsoidalCoreShell", "Kholodenko",
    "CylindersIsotropicAspect", "CylindersRadiallyIsotropic",
    "CylindersRadiallyIsotropicTilted",
)


def get_model(name: str) -> SASModel:
    try:
        return REGISTRY[name]
    except KeyError:
        if name in _NOT_PORTED:
            raise KeyError(
                f"model {name!r} is not ported to PyTorch yet; it comes "
                "in a later PR of the port (ROADMAP.md, Queue A)") from None
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(REGISTRY)}") from None


__all__ = ["SASModel", "BoundModel", "ParamSpec", "MODELS", "REGISTRY",
           "get_model", "Sphere", "LMADenseSphere", "GaussianChain",
           "SphericalCoreShell", "CylindersIsotropic"]
