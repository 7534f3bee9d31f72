# -*- coding: utf-8 -*-
"""Algorithm configuration: one typed, JSON-round-trippable dataclass.

Replaces the reference's four config mechanisms (JSON parameter defaults,
Parameter introspection, argparse, QSettings; reference:
src/mcsas/mcsas/mcsasparameters.json:1-104 and mcsasparameters.py:78-105)
with a single frozen dataclass.  Field names keep the reference's JSON keys
(camelCase) in serialized form for drop-in compatibility.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class McSASConfig:
    # --- reference algorithm parameters (mcsasparameters.json) ----------
    num_contribs: int = 300          # numContribs
    num_reps: int = 10               # numReps
    max_iterations: int = 100000     # maxIterations
    compensation_exponent: float = 0.6666666  # compensationExponent
    convergence_criterion: float = 1.0        # convergenceCriterion
    find_background: bool = True     # findBackground
    positive_background: bool = False  # positiveBackground
    start_from_minimum: bool = False   # startFromMinimum (deprecated)
    max_retries: int = 5             # maxRetries
    auto_close: bool = False         # autoClose (plotting)
    series_stats: bool = False       # seriesStats
    show_incomplete: bool = False    # showIncomplete
    # --- rebuild-specific execution parameters --------------------------
    seed: int = 0                    # base PRNG seed (keyed, reproducible)
    dtype: str = "float32"           # device compute dtype
    chunk_steps: int = 2048     # scan steps per host convergence check
    device_mesh: Optional[tuple] = None   # e.g. ("rep", 4) axis spec
    # Speculative proposals: per MC step, evaluate this many candidate
    # replacements for the current contribution in parallel and accept the
    # best improving one.  1 == exact reference stepping (one proposal per
    # iteration, mcsas.py:358); >1 trades idle vector lanes for a ~K×
    # higher proposal rate at the same per-step latency.  The accept
    # criterion and per-slot proposal distribution are unchanged, so the
    # fitted distributions are statistically equivalent.
    candidates_per_step: int = 1
    # Fused chunk kernel (the field keeps its JSON name): "auto" uses a
    # CUDA kernel where one runs the config -- K1 for the four elementwise
    # models (Sphere, LMADenseSphere, GaussianChain, SphericalCoreShell)
    # unsmeared in float32, K2 for the parameter-table tier in float32 --
    # and on the card raises where none does; "on" forces it (errors if
    # unsupported), "off" always runs the plain PyTorch chunk.  On a CPU
    # tensor the kernel's plain version runs.
    use_pallas: str = "auto"
    # Beyond-reference convergence accelerator (opt-in, default off =
    # exact reference proposal semantics): this fraction of each step's
    # candidates is drawn as log-uniform perturbations of the slot's
    # current value, current·exp(±local_scale), clipped to the active
    # range.  Dramatically speeds the narrow-basin tail of convergence
    # (monodisperse / joint multi-parameter populations); the accept rule
    # is unchanged, so the result is still a strict-descent MC fit.
    local_moves: float = 0.0
    local_scale: float = 0.2
    # Parameter-table tier for quadrature models (ops/tables.py): "auto"
    # bakes a table when the proposal budget amortizes the bake (see
    # table_ff_enabled), "on" always, "off" never.
    table_ff: str = "auto"
    # Kept so configurations round-trip through JSON unchanged: the
    # float32 post tier is not part of this package (its post pass always
    # runs float64 on the engine's device).
    post_compute: str = "auto"

    _JSON_KEYS = {
        "num_contribs": "numContribs",
        "num_reps": "numReps",
        "max_iterations": "maxIterations",
        "compensation_exponent": "compensationExponent",
        "convergence_criterion": "convergenceCriterion",
        "find_background": "findBackground",
        "positive_background": "positiveBackground",
        "start_from_minimum": "startFromMinimum",
        "max_retries": "maxRetries",
        "auto_close": "autoClose",
        "series_stats": "seriesStats",
        "show_incomplete": "showIncomplete",
        "seed": "seed",
        "dtype": "dtype",
        "chunk_steps": "chunkSteps",
        "device_mesh": "deviceMesh",
        "candidates_per_step": "candidatesPerStep",
        "use_pallas": "usePallas",
        "local_moves": "localMoves",
        "local_scale": "localScale",
        "table_ff": "tableFF",
        "post_compute": "postCompute",
    }

    def __post_init__(self):
        if self.num_contribs < 1:
            raise ValueError("num_contribs must be >= 1")
        if self.num_reps < 1:
            raise ValueError("num_reps must be >= 1")
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")
        if self.convergence_criterion < 0:
            raise ValueError("convergence_criterion must be >= 0")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.candidates_per_step < 1:
            raise ValueError("candidates_per_step must be >= 1")
        if not 0.0 <= self.local_moves <= 1.0:
            raise ValueError("local_moves must be in [0, 1]")
        if self.local_moves > 0.0 and self.candidates_per_step < 2:
            raise ValueError("local_moves requires candidates_per_step >= 2")
        if self.table_ff not in ("auto", "on", "off"):
            raise ValueError("table_ff must be 'auto', 'on' or 'off'")
        if self.post_compute not in ("auto", "cpu", "accel"):
            raise ValueError(
                "post_compute must be 'auto', 'cpu' or 'accel'")

    def table_ff_enabled(self) -> bool:
        """Resolved table decision: 'auto' requires the total proposal
        budget to amortize the one-time table build (~1 GFLOP)."""
        if self.table_ff == "off":
            return False
        if self.table_ff == "on":
            return True
        return self.num_reps * self.max_iterations >= 200_000

    def replace(self, **kw) -> "McSASConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------ JSON IO
    def to_dict(self) -> dict:
        out = {}
        for field, key in self._JSON_KEYS.items():
            v = getattr(self, field)
            if isinstance(v, tuple):
                v = list(v)
            out[key] = v
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "McSASConfig":
        inv = {key: field for field, key in cls._JSON_KEYS.items()}
        kwargs = {}
        for key, value in d.items():
            field = inv.get(key, None)
            if field is None:
                # tolerate both camelCase and snake_case inputs
                if key in cls._JSON_KEYS:
                    field = key
                else:
                    continue  # unknown keys are ignored (fwd compat)
            if field == "device_mesh" and value is not None:
                value = tuple(value)
            kwargs[field] = value
        # coerce integer-ish floats the reference stores (e.g. 1e5)
        for intf in ("num_contribs", "num_reps", "max_iterations",
                     "max_retries", "chunk_steps", "seed",
                     "candidates_per_step"):
            if intf in kwargs:
                kwargs[intf] = int(kwargs[intf])
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "McSASConfig":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_reference_json(cls, path) -> "McSASConfig":
        """Loads defaults from a reference-style mcsasparameters.json
        (each key maps to an object with a 'default' entry)."""
        with open(path, "r", encoding="utf-8") as fd:
            raw = json.load(fd)
        flat = {k: v.get("default") for k, v in raw.items()
                if isinstance(v, dict) and "default" in v}
        return cls.from_dict(flat)
