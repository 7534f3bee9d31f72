# -*- coding: utf-8 -*-
"""Units-of-measurement conversion, pure-function style.

Replicates the unit semantics of the reference McSAS units system
(reference: src/mcsas/utils/units.py:46-344): every quantity is stored in SI
internally; conversion to/from a *display magnitude* happens only at the API
boundary.  Unlike the reference (which is a class hierarchy entangled with GUI
metadata), this is a slim immutable value type with a magnitude table per
dimension, so it can live inside static model specs and configs that are
hashable and jit-friendly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


class UnitError(ValueError):
    pass


@dataclass(frozen=True)
class Unit:
    """A dimension with a magnitude table and a selected display magnitude.

    ``si_name`` is the magnitude whose factor is 1 in SI; ``display`` is the
    magnitude used at the UI/file boundary (defaults to SI).
    ``factor(name)`` returns how many SI units one ``name`` unit is.
    """
    kind: str
    si_name: str
    display: str
    magnitudes: tuple  # tuple of (name, factor) pairs — hashable

    def factor(self, name: str) -> float:
        for n, f in self.magnitudes:
            if n == name:
                return f
        raise UnitError(f"unknown magnitude {name!r} for {self.kind}")

    @property
    def magnitude_conversion(self) -> float:
        """Scale factor from display magnitude to SI."""
        return self.factor(self.display) / self.factor(self.si_name)

    def to_si(self, value):
        c = self.magnitude_conversion
        if isinstance(value, (tuple, list)):
            return type(value)(v * c for v in value)
        return value * c

    def to_display(self, value):
        c = self.magnitude_conversion
        if isinstance(value, (tuple, list)):
            return type(value)(v / c for v in value)
        return value / c

    def with_display(self, name: str) -> "Unit":
        self.factor(name)  # validate
        return Unit(self.kind, self.si_name, name, self.magnitudes)

    @property
    def available(self):
        return tuple(n for n, _ in self.magnitudes)

    def __call__(self, name: str) -> "Unit":
        return self.with_display(name)


def _unit(kind, si_name, mags, display=None):
    return Unit(kind, si_name, display or si_name, tuple(mags.items()))


# Dimension tables (reference: utils/units.py:252-335)
Length = _unit("Length", "m", {
    "Å": 1e-10, "nm": 1e-9, "µm": 1e-6, "mm": 1e-3, "cm": 1e-2, "m": 1.0})
Area = _unit("Area", "m²", {
    "Å²": 1e-20, "nm²": 1e-18, "µm²": 1e-12, "mm²": 1e-6, "m²": 1.0})
Volume = _unit("Volume", "m³", {
    "Å³": 1e-30, "nm³": 1e-27, "µm³": 1e-18, "mm³": 1e-9, "m³": 1.0})
Angle = _unit("Angle", "rad", {
    "°": math.pi / 180.0, "'": math.pi / 3.0, '"': math.pi / 0.05, "rad": 1.0})
SLD = _unit("SLD", "m⁻²", {
    "Å⁻²": 1e20, "nm⁻²": 1e18, "µm⁻²": 1e12, "mm⁻²": 1e6, "cm⁻²": 1e4,
    "m⁻²": 1.0})
ScatteringVector = _unit("ScatteringVector", "m⁻¹", {
    "Å⁻¹": 1e10, "nm⁻¹": 1e9, "µm⁻¹": 1e6, "mm⁻¹": 1e3, "cm⁻¹": 1e2,
    "m⁻¹": 1.0})
ScatteringIntensity = _unit("ScatteringIntensity", "(m sr)⁻¹", {
    "(cm sr)⁻¹": 1e2, "(m sr)⁻¹": 1.0})
Fraction = _unit("Fraction", "-", {"%": 1e-2, "-": 1.0, "": 1.0})
NoUnit = _unit("NoUnit", "-", {"": 1.0, "-": 1.0})
Time = _unit("Time", "s", {"ns": 1e-9, "µs": 1e-6, "ms": 1e-3, "s": 1.0})
DynamicViscosity = _unit("DynamicViscosity", "N s m⁻²", {
    "Pa s": 1.0, "kg m⁻¹ s⁻¹": 1.0, "N s m⁻²": 1.0, "mPa s": 1e-3,
    "centiPoise": 1e-3, "cp": 1e-3, "cP": 1e-3, "poise": 1e-1,
    "dyne s cm⁻²": 1e-1, "g cm⁻¹ s⁻¹": 1e-1, "sl ft⁻¹ s⁻¹": 47.880})


@dataclass(frozen=True)
class TemperatureUnit(Unit):
    """Temperature needs affine (not multiplicative) conversions
    (reference: utils/units.py:174-223)."""

    def to_si(self, value):
        n = self.display
        if n in ("°F", "F"):
            return (value + 459.67) * 5.0 / 9.0
        if n in ("°C", "C"):
            return value + 273.15
        if n in ("°R", "R"):
            return value * 5.0 / 9.0
        if n in ("°De", "De"):
            return 373.15 - value * 2.0 / 3.0
        return value

    def to_display(self, value):
        n = self.display
        if n in ("°F", "F"):
            return value * 9.0 / 5.0 - 459.67
        if n in ("°C", "C"):
            return value - 273.15
        if n in ("°R", "R"):
            return value * 9.0 / 5.0
        if n in ("°De", "De"):
            return (373.15 - value) * 3.0 / 2.0
        return value

    def with_display(self, name: str) -> "TemperatureUnit":
        self.factor(name)
        return TemperatureUnit(self.kind, self.si_name, name,
                               self.magnitudes)

    __call__ = with_display


Temperature = TemperatureUnit("Temperature", "K", "K", tuple(
    (n, 1.0) for n in ("°F", "F", "°C", "C", "K", "°R", "R", "°De", "De")))

# Common shortcuts mirroring the reference module-level instances
NM = Length("nm")
ANGSTROM_SLD = SLD("Å⁻²")
NM_INV = ScatteringVector("nm⁻¹")
DEG = Angle("°")

_BY_KIND = {u.kind: u for u in (
    Length, Area, Volume, Angle, SLD, ScatteringVector, ScatteringIntensity,
    Fraction, NoUnit, Time, DynamicViscosity, Temperature)}


def unit_by_kind(kind: str, display: str = None) -> Unit:
    u = _BY_KIND[kind]
    return u.with_display(display) if display else u
