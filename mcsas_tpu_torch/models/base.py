# -*- coding: utf-8 -*-
"""Model abstraction: analytical scattering models as pure-function kernels.

The reference models are stateful class hierarchies whose parameters are
mutated per-contribution inside a Python loop (reference:
src/mcsas/bases/model/scatteringmodel.py:79-105, sasmodel.py:11-79).  Here a
model is an immutable spec — parameter metadata plus pure kernels

    ff(q, p)       form factor F(q) for a parameter dict p of tensors
    volume(p)      scatterer volume
    absvolume(p)   volume with SLD² contrast folded in (defaults to volume)
    surface(p)     scatterer surface (defaults to 0)

written with broadcasting torch operations, so a batch of contributions is
one call.  A :class:`BoundModel` fixes which parameters are active (fitted)
and their sampling ranges, turning parameter *vectors* (..., P) into kernel
inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from ..utils.units import NoUnit, Unit

GENERATORS = ("uniform", "logdec1", "logdec2", "logdec3")


@dataclass(frozen=True)
class ParamSpec:
    """Metadata for one model parameter; all values in SI units.

    ``generator`` names the proposal distribution used for active
    parameters: 'uniform' (reference RandomUniform) or 'logdecN'
    (reference RandomExponential{1,2,3}, inverse-log-probability over N
    decades; reference: src/mcsas/bases/algorithm/numbergenerator.py:28-31,
    168-189).
    """
    name: str
    default: float
    unit: Unit = NoUnit
    value_range: Tuple[float, float] = (0.0, float("inf"))
    active_range: Optional[Tuple[float, float]] = None
    generator: str = "uniform"
    is_fit: bool = False
    display_name: str = ""

    def __post_init__(self):
        if self.generator not in GENERATORS:
            raise ValueError(f"unknown generator {self.generator!r}")

    def clip(self, rng) -> Tuple[float, float]:
        lo, hi = min(rng), max(rng)
        vlo, vhi = self.value_range
        return (min(max(lo, vlo), vhi), min(max(hi, vlo), vhi))

    def effective_active_range(self) -> Tuple[float, float]:
        """Active range falls back to the value range like the reference
        (src/mcsas/utils/parameter.py:625-630)."""
        return self.clip(self.active_range if self.active_range is not None
                         else self.value_range)

    def display_default(self) -> float:
        return self.unit.to_display(self.default)


def _zero_surface(p):
    return 0.0


@dataclass(frozen=True)
class SASModel:
    """Immutable spec of an analytical SAS model."""
    name: str
    params: Tuple[ParamSpec, ...]
    ff: Callable
    volume: Callable
    absvolume: Optional[Callable] = None
    surface: Callable = _zero_surface
    # optional reduced-precision form factor for the float32 MC hot loop
    # (e.g. a coarser quadrature); float64 analysis always uses ``ff``
    ff_fast: Optional[Callable] = None
    # optional parameter-table builder (ops/tables.py):
    # factory(bound, q_grid, dtype, device) -> (table_fn, ParamTable) or
    # None.  When set, the float32 MC loop replaces the model's quadrature
    # with a multilinear blend of rows baked on the fit grid (fit-grade
    # tier, like ff_fast); float64 analysis always uses ``ff``.  A factory
    # that also declares ``smear=None`` is asked for smeared data with
    # smear=(locs, smear_w) and returns (table_fn, ParamTable,
    # "intensity"): rows of the smeared intensity ff²(locs) @ smear_w
    ff_table_factory: Optional[Callable] = None
    # optional anisotropic kernel ff2d(q, psi, p) for 2D (q, ψ) fitting
    # (DataConfig.fit_2d); ``ff`` remains the azimuthal average used for
    # 1D data.  Re-designs the reference's dormant 2D path
    # (mcsas.py:617-651).
    ff2d: Optional[Callable] = None
    can_smear: bool = False
    default_active: Tuple[str, ...] = ()
    doc: str = ""
    # True when ff() is purely elementwise in q (no quadrature grids):
    # the fused chunk kernel evaluates such models in-kernel
    elementwise_q: bool = False

    def spec(self, name: str) -> ParamSpec:
        for s in self.params:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no parameter {name!r}")

    @property
    def param_names(self):
        return tuple(s.name for s in self.params)

    def defaults(self) -> dict:
        return {s.name: s.default for s in self.params}

    def absvolume_fn(self):
        return self.absvolume if self.absvolume is not None else self.volume

    def bind(self, active=None, active_ranges=None,
             fixed=None) -> "BoundModel":
        """Creates a BoundModel with the given active parameters.

        - *active*: names of fitted parameters (default: model's
          default_active set)
        - *active_ranges*: optional {name: (lo, hi)} SI overrides
        - *fixed*: optional {name: value} SI overrides for inactive params
        """
        if active is None:
            active = self.default_active
        active = tuple(active)
        if not active:
            # fail here with a clear message instead of deep inside the
            # engine's RNG (a plugin model without default_active would
            # otherwise crash with "Need at least one array to stack")
            fittable = [s.name for s in self.params if s.is_fit]
            raise ValueError(
                f"{self.name}: no active (fitted) parameters; pass "
                f"active=... to bind() or declare default_active on the "
                f"model (fittable: {fittable})")
        for n in active:
            if not self.spec(n).is_fit:
                raise ValueError(f"parameter {n!r} of {self.name} is not "
                                 "fittable")
        active_ranges = dict(active_ranges or {})
        ranges = tuple(
            self.spec(n).clip(active_ranges[n]) if n in active_ranges
            else self.spec(n).effective_active_range() for n in active)
        fixed = dict(fixed or {})
        fixed_items = tuple((s.name, float(fixed.get(s.name, s.default)))
                            for s in self.params if s.name not in active)
        gens = tuple(self.spec(n).generator for n in active)
        return BoundModel(model=self, active=active, ranges=ranges,
                          generators=gens, fixed=fixed_items)


@dataclass(frozen=True)
class BoundModel:
    """A model with a chosen active-parameter set, ready for fitting.

    Parameter vectors handled by the engine have shape (..., P) with columns
    ordered like ``active``.
    """
    model: SASModel
    active: Tuple[str, ...]
    ranges: Tuple[Tuple[float, float], ...]     # SI sampling ranges
    generators: Tuple[str, ...]
    fixed: Tuple[Tuple[str, float], ...]

    @property
    def n_active(self) -> int:
        return len(self.active)

    def pdict(self, values) -> dict:
        """Maps active-parameter vectors (..., P) to the full parameter
        dict; each active entry has the leading shape (...)."""
        p = dict(self.fixed)
        for i, n in enumerate(self.active):
            p[n] = values[..., i]
        return p

    # pure scalar kernels over a parameter vector -------------------------
    def ff(self, q, values):
        return self.model.ff(q, self.pdict(values))

    def volume(self, values):
        return self.model.volume(self.pdict(values))

    def absvolume(self, values):
        return self.model.absvolume_fn()(self.pdict(values))

    def surf(self, values):
        return self.model.surface(self.pdict(values))

    def weight(self, values, comp_exp):
        """w = volume^(2c): the intensity weighting used during fitting
        (reference: src/mcsas/bases/model/sasmodel.py:37-44)."""
        return self.volume(values) ** (2.0 * comp_exp)

    def reference_volume(self) -> float:
        """A float64 host-side normalization volume: the volume at the
        geometric mean of each active sampling range (with fixed params at
        defaults).  Used to keep w/w_ref ≈ O(1) so the float32 MC loop
        never underflows (v^(4/3) for nm-scale particles is ~1e-32 in SI)."""
        vals = []
        for (lo, hi) in self.ranges:
            lo = max(lo, 1e-300)
            vals.append(float(np.sqrt(lo * hi) if hi > 0 else lo))
        v = self.volume(np.asarray(vals, dtype=np.float64))
        v = abs(float(v))
        return v if v > 0 else 1.0
