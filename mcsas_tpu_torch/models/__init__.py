# -*- coding: utf-8 -*-
"""Model bank of the PyTorch port: the registry of the eleven models of
the JAX package (mcsas_tpu/models/__init__.py)."""
from __future__ import annotations

from .base import BoundModel, ParamSpec, SASModel
from .chains import GaussianChain, Kholodenko
from .cylinders import (CylindersIsotropic, CylindersIsotropicAspect,
                        CylindersRadiallyIsotropic,
                        CylindersRadiallyIsotropicTilted)
from .ellipsoids import (EllipsoidalCoreShell, EllipsoidsIsotropic,
                         SphericalCoreShell)
from .sphere import LMADenseSphere, Sphere

MODELS = (Sphere, LMADenseSphere, GaussianChain, Kholodenko,
          SphericalCoreShell, EllipsoidsIsotropic, EllipsoidalCoreShell,
          CylindersIsotropic, CylindersIsotropicAspect,
          CylindersRadiallyIsotropic, CylindersRadiallyIsotropicTilted)

REGISTRY = {m.name: m for m in MODELS}


def get_model(name: str) -> SASModel:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(REGISTRY)}") from None


__all__ = ["SASModel", "BoundModel", "ParamSpec", "MODELS", "REGISTRY",
           "get_model", "Sphere", "LMADenseSphere", "GaussianChain",
           "Kholodenko", "SphericalCoreShell", "EllipsoidsIsotropic",
           "EllipsoidalCoreShell", "CylindersIsotropic",
           "CylindersIsotropicAspect", "CylindersRadiallyIsotropic",
           "CylindersRadiallyIsotropicTilted"]
