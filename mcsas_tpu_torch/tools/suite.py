# -*- coding: utf-8 -*-
"""The suite rows of ``bench.py --suite`` (bench.py:155-222) whose chunks
run in K1, as the port fits them: data file, model, active set and
ranges, K, proposal budget and local moves; 300 contributions × 10
repetitions, chunks of 1024 steps, seed 2026, one retry, χ² ≤ 1.
``chip_smoke.py`` fits them on the card and ``tools/kern_probe.py``
probes K1 on their data.
"""
from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Optional

from ..api import _default_unbounded_ranges
from ..config import McSASConfig
from ..data import SASData, load
from ..models import get_model
from ..models.base import BoundModel

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
