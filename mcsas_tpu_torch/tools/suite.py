# -*- coding: utf-8 -*-
"""The suite rows of ``bench.py --suite`` (bench.py:155-222) whose chunks
run in K1, as the port fits them: data file, model, active set and
ranges, K, proposal budget and local moves; 300 contributions × 10
repetitions, chunks of 1024 steps, seed 2026, one retry, χ² ≤ 1.
``chip_smoke.py`` fits them on the card and ``tools/kern_probe.py``
probes K1 on their data.  The table-tier row 'cylinders-isotropic'
(bench.py:162-164), whose segments run in K2, stands beside them as
:func:`cylinder_golden`, :func:`cylinder_bound` and
:func:`cylinder_config`: its data is synthetic and made here.
"""
from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..api import _default_unbounded_ranges
from ..config import McSASConfig
from ..data import DataConfig, SASData, from_raw, load
from ..models import get_model
from ..models.base import BoundModel
from ..models.cylinders import _cyl_iso_ff_ab

_TESTDATA = pathlib.Path(__file__).resolve().parents[2] / "testdata"


@dataclass(frozen=True)
class SuiteRow:
    name: str
    data: str                  # path under testdata/
    model: str
    active: Optional[tuple]    # None: the model's default active set
    ranges: Optional[dict]     # SI active-range overrides
    k_cand: int
    budget: int                # max_iterations
    local_moves: float
    # the parameters that generated the data, SI as the data load (q in
    # nm⁻¹): what the vol-weighted means of a converged fit come near
    truth: dict

    def load(self) -> SASData:
        return load(_TESTDATA / self.data)

    def bound(self, data: SASData, active=None) -> BoundModel:
        """The row's binding, or the model's with *active* instead (the
        row's ranges kept where they apply); an unbounded active range
        becomes the data's size estimate, as ``fit()`` makes it."""
        active = self.active if active is None else active
        ranges = {k: v for k, v in (self.ranges or {}).items()
                  if active is None or k in active}
        bound = get_model(self.model).bind(active=active,
                                           active_ranges=ranges or None)
        return _default_unbounded_ranges(bound, data)

    def config(self, **kw) -> McSASConfig:
        base = dict(num_contribs=300, num_reps=10,
                    max_iterations=self.budget, chunk_steps=1024,
                    candidates_per_step=self.k_cand, seed=2026,
                    max_retries=1, convergence_criterion=1.0,
                    local_moves=self.local_moves, show_incomplete=True)
        base.update(kw)
        return McSASConfig(**base)


ROWS = {row.name: row for row in (
    SuiteRow("gaussian-chain", "sasfit_gauss2-5-1.5-2-1.dat",
             "GaussianChain", None, None, 64, 4_000_000, 0.0,
             {"rg": 5e-9}),
    SuiteRow("core-shell-sphere",
             "models/SphCoreShell_R100_dR150_c3p16_s2p53.csv",
             "SphericalCoreShell", ("radius", "t"), None, 128, 40_000_000,
             0.5, {"radius": 100e-9, "t": 150e-9}),
    SuiteRow("lma-dense-sphere", "sasfit_sphere-10-1.dat",
             "LMADenseSphere", ("radius", "volFrac"),
             {"volFrac": (1e-4, 0.1)}, 128, 20_000_000, 0.5,
             {"radius": 10e-9}),
)}


GOLDEN_RADIUS = 10e-9     # the synthetic cylinder's radius (aspect 10)


def cylinder_golden() -> SASData:
    """bench.synth_golden("cylinder") built with the port's float64
    functions: q = geomspace(0.01, 2, 100) nm⁻¹, I = ff² of the converged
    n=801 orientation rule at R = 10 nm, aspect 10, normalized to max 1,
    σ = 0.01·I, no rebinning."""
    q_nm = np.geomspace(0.01, 2.0, 100)
    q = torch.as_tensor(q_nm * 1e9, dtype=torch.float64)
    r, asp = GOLDEN_RADIUS, 10.0
    ff = _cyl_iso_ff_ab(q * r, q * (2.0 * r * asp), 801,
                        torch.float64).numpy()
    i = ff ** 2
    i = i / i.max()
    return from_raw(np.column_stack([q_nm, i, 0.01 * i]),
                    title="synthetic-cylinder", config=DataConfig(n_bin=0))


def cylinder_bound() -> BoundModel:
    return get_model("CylindersIsotropic").bind(
        active=("radius",), active_ranges={"radius": (0.5e-9, 300e-9)})


def cylinder_config(**kw) -> McSASConfig:
    """bench.py's suite row 'cylinders-isotropic' (bench.py:162-164,
    213-222); table_ff 'auto' resolves to on at this budget."""
    base = dict(num_contribs=300, num_reps=10, max_iterations=8_000_000,
                chunk_steps=1024, candidates_per_step=128, seed=2026,
                max_retries=1, convergence_criterion=1.0, local_moves=0.0,
                show_incomplete=True)
    base.update(kw)
    return McSASConfig(**base)
