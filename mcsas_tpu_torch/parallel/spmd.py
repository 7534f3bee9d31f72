# -*- coding: utf-8 -*-
"""The MC ensemble over a device mesh: :class:`ShardedEnsemble`, the JAX
package's mcsas_tpu/parallel/spmd.py with one coordinating process
instead of ``shard_map``.

* **Draws.**  The coordinator keeps the engine's one generator on the
  mesh's first device and draws exactly what the unsharded engine draws —
  the init and retry batches, K1's per-chunk Philox seed, the segment
  proposals of a table engine or of an elementwise plugin — then slices
  them by repetition.  So a repetition shard runs the repetitions it
  would run unsharded, on the same numbers.
* **The rep axis.**  Each repetition shard holds its part of the state on
  its device and launches on its own CUDA stream: K1 with its
  ``rep_base`` (the Philox stream of repetition ``rep_base + r``), or the
  entry of K2 the engine picked (an elementwise plugin: the rows entry,
  as the JAX package's ``fused_ok`` shards K1 for it,
  mcsas_tpu/parallel/spmd.py:74-84), on the parent's ``seg_steps`` (the
  segment length depends on the whole ensemble's size, and so does the
  draw; the JAX package's per-shard engine clone does not apply here).
  Without a card each shard runs the plain chunk.  Once a chunk the host
  reads every shard's χ² and counters, and :meth:`McSASEngine.run`'s
  convergence, stuck, retry and abort logic runs on the concatenated
  vectors, unchanged.  A shard with no repetitions launches nothing.
* **The q axis** (n_q > 1).  Each q shard of a repetition shard holds its
  columns of the bank, ft, y, u, the grid (the rows of a smeared fit's
  ``locs``, ψ of a 2D fit) and the table's values, and a copy of the
  rest of the state.  A step evaluates each shard's columns of the
  candidates' rows, joins the solve's sums across the shards
  (``fitcore.solve_scale_bg`` on a list) and applies one decision on
  every shard: the plain chunk, since neither kernel sums across shards
  (mcsas_tpu/parallel/spmd.py:60-64); an elementwise plugin runs the
  plain chunk there, as the JAX package's scan.  On the card
  ``use_pallas='auto'`` and ``'on'`` raise there, ``'off'`` runs it.
  Only tables whose rows lie on the fit grid are taken
  (``table_grid_width_only``, the JAX package's rule).

``prewarm()`` prewarms every repetition shard's device (the kernel's
attributes queried on each).  Not ported, as for the unsharded engine:
the device while-loop drive, the AOT prewarm plan and the Mosaic
fallback engine (mcsas_tpu/parallel/spmd.py:178-262).
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..config import McSASConfig
from ..core.engine import (McSASEngine, RepState, chunk_vectors,
                           fresh_state, resolve_device, state_to_numpy)
from ..core.fitcore import FitConstants
from ..data import SASData
from ..models.base import BoundModel
from ..ops import mc_kernel
from ..ops.tables import ParamTable
from ..utils import profiling
from .mesh import Mesh, make_mesh, q_slices, rep_slices


@dataclass
class _Shard:
    """One repetition shard: its repetitions and, per q shard, the device,
    the fit constants, the row kernel and the chunk spec; on the card
    without a q split, its own stream."""
    reps: slice
    devices: tuple
    consts: tuple
    kerns: tuple
    specs: tuple
    stream: Optional[object] = None

    @property
    def n_reps(self) -> int:
        return self.reps.stop - self.reps.start


def _one(seq):
    """A sequence of one q shard as its element, else a list."""
    return seq[0] if len(seq) == 1 else list(seq)


def _cols(t: Optional[torch.Tensor], cols: slice, dev):
    return None if t is None else t[cols].contiguous().to(dev)


def shard_kernel(kern, cols: slice, dev):
    """The engine's row kernel for the fit-grid points *cols* on *dev*:
    the same object where that is the whole grid on its own device.  A
    table's lookup must declare that it only blends (``tab_params``
    without ``row_factor``: ``tables.make_lookup``) or how it moves to
    other points (``on_grid(q)``); any other lookup raises, as does a
    table whose rows are not on the fit grid."""
    if cols == slice(0, kern.grid.numel()) and dev == kern.grid.device:
        return kern
    grid = _cols(kern.grid, cols, dev)
    table, table_fn = kern.table, kern.table_fn
    if table is not None:
        on_grid = getattr(table_fn, "on_grid", None)
        plain = (getattr(table_fn, "tab_params", None) is not None
                 and getattr(table_fn, "row_factor", None) is None)
        if table.values.shape[1] != kern.grid.numel() or not (on_grid
                                                              or plain):
            raise ValueError(
                f"{kern.bound.model.name}'s table lookup cannot move to a "
                f"shard's q points or device: it neither only blends "
                f"(tables.make_lookup) nor declares on_grid(q), or its rows "
                f"are not on the fit grid")
        table = ParamTable(table.values[:, cols].contiguous().to(dev),
                           table.axes)
        table_fn = on_grid(grid) if on_grid else table_fn
    return dataclasses.replace(
        kern, grid=grid, locs=_cols(kern.locs, cols, dev),
        smear_w=None if kern.smear_w is None else kern.smear_w.to(dev),
        psi=_cols(kern.psi, cols, dev), table=table, table_fn=table_fn)


def shard_constants(consts: FitConstants, cols: slice, dev) -> FitConstants:
    """The fit constants of the points *cols* on *dev* (``s_u``, ``s_uy``
    and ``n`` stay the whole grid's)."""
    if cols == slice(0, consts.n) and dev == consts.y.device:
        return consts
    return dataclasses.replace(consts, y=_cols(consts.y, cols, dev),
                               u=_cols(consts.u, cols, dev))


class ShardedEnsemble(McSASEngine):
    """McSASEngine whose ensemble runs over the shards of a device mesh
    (by default ``make_mesh()``: every visible card on the rep axis; see
    the module's docstring).  ``run()`` returns one EngineResult of the
    unsharded shape; a mesh of one shard is the unsharded engine."""

    def __init__(self, data: SASData, bound: BoundModel, cfg: McSASConfig,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        kinds = {d.type for d in self.mesh.devices}
        if len(kinds) != 1:
            raise ValueError(f"a mesh spans one kind of device, got "
                             f"{sorted(kinds)}")
        for d in self.mesh.devices:
            resolve_device(d)
        n_rep, n_q = self.mesh.shape
        self._table_grid_width_only = n_q > 1
        super().__init__(data, bound, cfg, device=self.mesh.devices[0])
        qs = self._q_cols = q_slices(self.consts.n, self.mesh)
        on_streams = self.device.type == "cuda" and n_q == 1
        cache = {}

        def part(make, obj, cols, dev):
            key = (make, cols.start, cols.stop, dev)
            if key not in cache:
                cache[key] = make(obj, cols, dev)
            return cache[key]

        self.shards = []
        for i, reps in enumerate(rep_slices(cfg.num_reps, self.mesh)):
            devs = tuple(self.mesh.device(i, j) for j in range(n_q))
            kerns = tuple(part(shard_kernel, self.kern, c, d)
                          for c, d in zip(qs, devs))
            self.shards.append(_Shard(
                reps=reps, devices=devs,
                consts=tuple(part(shard_constants, self.consts, c, d)
                             for c, d in zip(qs, devs)),
                kerns=kerns,
                specs=tuple(self.spec if k is self.kern
                            else dataclasses.replace(self.spec, kern=k)
                            for k in kerns),
                stream=torch.cuda.Stream(devs[0]) if on_streams else None))

    # ---------------------------------------------------- kernel route
    def _kernel_eligible(self) -> bool:
        return self.mesh.shape[1] == 1 and super()._kernel_eligible()

    def _no_kernel_reason(self) -> str:
        n_q = self.mesh.shape[1]
        if n_q > 1:
            return (f"the mesh shards the q axis into {n_q}: the solve's "
                    "sums cross the q shards, which neither K1 nor K2 "
                    "does")
        return super()._no_kernel_reason()

    # ------------------------------------------------------ the shards
    def _live(self, states):
        """(shard, its q-shard states) of every shard with repetitions."""
        return [(sh, cells) for sh, cells in zip(self.shards, states)
                if cells is not None]

    @contextlib.contextmanager
    def _on_streams(self):
        """Yields a context factory that runs a shard's work on its own
        stream (a no-op without streams); every shard stream first waits
        for the work already queued on its device, and the devices'
        current streams wait for every shard stream on exit."""
        streams = [sh.stream for sh in self.shards if sh.stream is not None]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(s.device))

        def on(shard):
            return (torch.cuda.stream(shard.stream) if shard.stream
                    is not None else contextlib.nullcontext())
        try:
            yield on
        finally:
            for s in streams:
                torch.cuda.current_stream(s.device).wait_stream(s)

    def _fresh(self, shard: _Shard, rset: torch.Tensor):
        if not shard.n_reps:
            return None
        return fresh_state(rset, list(shard.kerns), list(shard.consts),
                           self.cfg)

    def _init_batch(self):
        rset = self._init_rset()
        return [self._fresh(sh, rset[sh.reps]) for sh in self.shards]

    def _retry(self, states, need_retry: np.ndarray):
        rset = self._init_rset()
        out = []
        for sh, cells in zip(self.shards, states):
            mask = need_retry[sh.reps]
            if cells is not None and mask.any():
                fresh = self._fresh(sh, rset[sh.reps])
                cells = [c.merge(f, torch.as_tensor(mask, device=d))
                         for c, f, d in zip(cells, fresh, sh.devices)]
            out.append(cells)
        return out

    def _chunk(self, states, ri: int):
        cfg = self.cfg
        n_steps = self.seg_steps if self.runs_prefetch else cfg.chunk_steps
        with profiling.span("core.engine.draw"):
            if self.runs_prefetch or not self.runs_cuda_kernel:
                props = self._draw_chunk_proposals(n_steps)
            else:
                # the unsharded engine's per-chunk Philox seed
                seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                         generator=self.gen,
                                         device=self.device))
        with self._on_streams() as on:
            for sh, cells in self._live(states):
                with on(sh):
                    if self.runs_cuda_kernel and not self.runs_prefetch:
                        with profiling.span("ops.mc_kernel.launch"):
                            mc_kernel.run_chunk(
                                cells[0], ri, sh.consts[0], sh.specs[0],
                                seed=seed, n_steps=n_steps,
                                rep_base=sh.reps.start)
                        continue
                    mine = props[:, sh.reps].to(sh.devices[0]).contiguous()
                    if not self.runs_prefetch:
                        with profiling.span("ops.mc_kernel.launch"):
                            mc_kernel.chunk_reference(
                                _one(cells), ri, _one(sh.consts),
                                _one(sh.specs), mine)
                    else:
                        self._shard_segment(sh, cells, ri, mine)
        return states, (ri + n_steps) % self.n_contribs

    def _shard_segment(self, sh: _Shard, cells, ri: int, props):
        """One prefetch segment of a shard, as the engine's ``_segment``
        runs it, on the shard's slice of the segment's proposals."""
        spec = sh.specs[0]
        with profiling.span("ops.mc_kernel.factors"):
            cands = mc_kernel.segment_candidates(cells[0], ri, spec, props)
            if not self.runs_cuda_kernel:
                made = None     # the plain version evaluates the rows
            elif self.prefetch_entry == "table":
                made = mc_kernel.table_factors(spec, cands)
            else:
                made = mc_kernel.segment_rows(spec, cands)
        with profiling.span("ops.mc_kernel.launch"):
            if not self.runs_cuda_kernel:
                mc_kernel.prefetch_table_reference(
                    _one(cells), ri, _one(sh.consts), _one(sh.specs), cands)
            elif self.prefetch_entry == "table":
                mc_kernel.run_prefetch_table_chunk(
                    cells[0], ri, sh.consts[0], spec, cands, made)
            else:
                mc_kernel.run_prefetch_chunk(
                    cells[0], ri, sh.consts[0], spec, made, cands)

    def _may_issue_ahead(self, running, n_iter) -> bool:
        """Never: the shards' chunks run in series, each issued after the
        read of the one before (``McSASEngine._run``'s lookahead keeps a
        whole state's ft, not the shards')."""
        return False

    def _kernel_work(self, states, props):
        """:meth:`McSASEngine.prewarm`'s work per repetition shard: each
        shard's state, constants, spec and slice of the proposals on its
        device, so that every shard's device is prewarmed."""
        return [(cells[0], sh.consts[0], sh.specs[0],
                 None if props is None
                 else props[:, sh.reps].to(sh.devices[0]).contiguous())
                for sh, cells in self._live(states)]

    # ----------------------------------------------------- host reads
    def _read(self, states, guard) -> torch.Tensor:
        parts = []
        for _, cells in self._live(states):
            vec = chunk_vectors(cells[0], guard)
            if guard:
                # every q shard's own ft columns
                flag = vec[2].long()
                for c in cells[1:]:
                    flag |= chunk_vectors(c, guard)[2].to(vec.device).long()
                vec[2] = flag.double()
            parts.append(vec.to(self.device))
        return torch.cat(parts, dim=1)

    def _host_state(self, states) -> dict:
        return {k: v for k, v in state_to_numpy(self.whole_state(states))
                .items() if k != "ibank"}

    # ------------------------------------------- whole and shard states
    def shard_state(self, state: RepState) -> list:
        """The per-shard states of a state of the whole ensemble: per
        repetition shard (None where it has no repetitions) a list over
        its q shards, each on its device with its columns of the bank
        and of ft (copies)."""
        out = []
        for sh in self.shards:
            if not sh.n_reps:
                out.append(None)
                continue
            cells = []
            for cols, dev in zip(self._q_cols, sh.devices):
                part = {}
                for f in fields(RepState):
                    t = getattr(state, f.name)[sh.reps]
                    if f.name in ("ibank", "ft"):
                        t = t[..., cols]
                    part[f.name] = t.to(dev, copy=True).contiguous()
                cells.append(RepState(**part))
            out.append(cells)
        return out

    def whole_state(self, states) -> RepState:
        """The state of the whole ensemble, on the mesh's first device, of
        per-shard states (:meth:`shard_state`'s layout)."""
        live = [cells for _, cells in self._live(states)]

        def join(name):
            if name in ("ibank", "ft"):
                parts = [torch.cat([getattr(c, name).to(self.device)
                                    for c in cells], dim=-1)
                         for cells in live]
            else:
                parts = [getattr(cells[0], name).to(self.device)
                         for cells in live]
            return torch.cat(parts)
        return RepState(**{f.name: join(f.name) for f in fields(RepState)})
