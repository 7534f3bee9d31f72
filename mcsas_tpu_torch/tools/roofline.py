# -*- coding: utf-8 -*-
"""Roofline of the MC chunk kernels on the card: the op model of K1 and
K2, and three measured sections.

The counterpart of the JAX package's tools/roofline.py and
tools/mfu_report.py.  **The op model** is the work a chunk must do,
whatever implements it: per candidate and q point the model's row
(:data:`ROW_OPS`; every +, -, *, /, sqrt, sin, cos, exp and pow counted as
one, so a lower bound) and the two passes of the solve (:data:`SOLVE_OPS`);
the state read and written once, the inputs read once.  Its bound
(:func:`bound_ms`) is the larger of the bytes over the H100 SXM's HBM rate
and the operations over its float32 rate (NVIDIA's data sheet, at the
full 700 W; the card's name and power limit go beside every figure).
``chip_smoke.py`` prices every kernel of its ``kernels`` line with it.

**Sections** (one JSON line each; ``--only=fused,prefetch,kab``):

* ``fused``: K1 on the Sphere headline shape (R=10, N=300, K=128, chunks of
  2048 steps, local moves 0.5) run by the engine with χ² ≤ 0, so that no
  repetition stops early, for a budget of 8 M proposals an attempt (the
  engine's two attempts: 62 chunks).  Steps/s, proposals/s, ms a chunk on
  the host clock of the engine's loop and, with CUDA events, of the kernel
  alone (the reset copy of the state included), the bound of a chunk and
  its share.  K1 runs one block a repetition, so the launch occupies R of
  the card's SMs (``sms_occupied`` beside ``sm_count``): the card's
  counterpart of the JAX script's latency argument.
* ``prefetch``: K2 on the cylinder row (``tools/suite.py``, 131-step
  segments): its table entry (the fit path) and its rows entry (the JAX
  kernel's contract) on one segment, CUDA events; ms a segment, bytes/s
  against HBM, operations/s, the bound and its share; and the engine's
  loop over a budget of 2 M proposals an attempt (ms a segment, host
  clock).
* ``kab``: the full headline ``fit()`` at K=128 and K=256 (budget 16 M),
  the better of two warm fits each, and the JAX script's verdict
  (tools/roofline.py:196-201): adopt K=256 only where its wall is smaller
  and it converges no fewer repetitions.

``mfu_report.py --compile-count`` (XLA executables a fresh fit compiles)
has no counterpart here: ``tools/coldstart.py`` splits a new process's
nvcc build, library load and first launches instead.  Needs a card (it
exits with an error naming it otherwise):

    python -m mcsas_tpu_torch.tools.roofline [--only=fused,prefetch,kab]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

_TESTDATA = pathlib.Path(__file__).resolve().parents[2] / "testdata"

# the operations per candidate and q point of a model's row (PERF.md §6)
ROW_OPS = {"Sphere": 12, "LMADenseSphere": 55, "GaussianChain": 14,
           "SphericalCoreShell": 25}
# the two passes of the solve (the float64 adds priced at the float32
# rate, which keeps the bound a lower one)
SOLVE_OPS = 14
# the worm's cross-section 2 j1(q r)/(q r) per candidate and q point, on its
# cheaper branch (|qr| <= 3: the product, two comparisons, the scaled
# square, the 7-term Horner, the sign, the division, the doubling and the
# multiply into the blend), so that the bound stays a lower one
XS_OPS = 23
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores, ditto
F64_OPS_PER_S = 34e12         # float64 outside the tensor cores, ditto
# the post pass's cylinder bank (csrc/cyl_bank.cu), float64 operations:
# J1 below |x| <= 3 (x/3, its square, the 7-term Horner, × x, × sign) and
# above (the reciprocal, × 3, two Horners, + x, cos, ×, sqrt, ÷, × sign)
J1_POLY_OPS = 16
J1_ASYM_OPS = 32
# an interior node besides its J1 (qR·s and qL·x two products each, the
# halving, sin, the numerator, the denominator, the division, the square,
# the sum) and an offset's two endpoints besides j1_over_x and sinc_sin
# (qR, the halving, qL, its halving, two squares, their sum, the halving,
# the sum); a smeared point adds its weight's product to each
NODE_OPS = 11
ENDS_OPS = 9
# the post pass's worm bank (csrc/kho_bank.cu), float64 operations, each
# +, -, *, /, sqrt, reciprocal, negation, clamp, sin, cos, sinh, cosh, exp
# and expm1 one.  Per contribution its set-up (h, 2/x, 2h/45) and per node of
# its grid g = (2/x)(1 - z/x) with z (4), phi = g s (1) and Boole's weight
# times 2h/45 times g (2); where z > 0 sinh z and its reciprocal (2); s by
# its series below z < 0.1 (6), else the halvings, 1/z and the difference (4)
KHO_SETUP_OPS = 5
KHO_NODE_OPS = 7
# per element: t = g k / 3, the clamped root of 1 - t^2 or t^2 - 1, its
# product with h (7); past the rule the clamp, the root, the cross-section's
# argument and doubling, ff and ff^2 (6); the slit's weight and sum (2)
KHO_ELEMENT_OPS = 7
KHO_END_OPS = 6
# a step of the hyperbolic recurrence with Boole's term (t < 1: four
# products, two sums; she / sinh z / e times the weight, the sum) and of the
# rotation with Filon's term (t >= 1: four products, two sums, the product
# with phi and its sum); each branch's sinh and cosh, or sin and cos, of e h
KHO_SUB_STEP_OPS = 10
KHO_SUP_STEP_OPS = 8
# Filon's coefficients by their series (th < 0.05) or closed form, and the
# assembly: F X with its sin and cos (3), S_e (3), the sum times h (8), the
# singular part (5) and (sing + 2 filon) / F (3)
KHO_FILON_SERIES_OPS = 19
KHO_FILON_CLOSED_OPS = 23
KHO_ASSEMBLY_OPS = 22
# a node of the tail (x > Z_CUT): z (2), 1 - e^-2z and the denominator (5),
# the numerator and the division of the sub (9) or sup (7) branch, the core
# (4) and its weighted sum (3); per element the span and the sum (2), else
# the sum of 0 (1)
KHO_TAIL_SUB_OPS = 23
KHO_TAIL_SUP_OPS = 21
STATE_FIELDS = ("rset", "ibank", "ft", "scale", "background", "conval",
                "n_iter", "n_moves")
SECTIONS = ("fused", "prefetch", "kab")
FUSED_BUDGET = 8_000_000
PREFETCH_BUDGET = 2_000_000
KAB_BUDGET = 16_000_000


def bound_ms(n_bytes, n_ops):
    """(ms, what bounds it): the least time the card could take to move
    *n_bytes* and do *n_ops* float32 operations."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _state_bytes(state):
    return sum(getattr(state, f).numel() * getattr(state, f).element_size()
               for f in STATE_FIELDS)


def _steps(eng, state0, state1):
    """The steps the repetitions ran from *state0* to *state1*, summed
    (a repetition's n_iter grows by K per step it ran)."""
    return int((state1.n_iter - state0.n_iter).sum()) // eng.spec.k_cand


def k1_work(eng, state0, state1, injected=None):
    """(bytes, operations) of the K1 chunk that took *state0* to *state1*:
    the state read and written once, q/y/u and any *injected* proposals
    read once; the rows and solves of the steps each repetition ran."""
    k, nq = eng.spec.k_cand, eng.consts.n
    n_bytes = 2 * _state_bytes(state0) + 3 * nq * 4
    if injected is not None:
        n_bytes += injected.numel() * 4
    ops = (_steps(eng, state0, state1) * k * nq
           * (ROW_OPS[eng.bound.model.name] + SOLVE_OPS))
    return n_bytes, ops


def k1_bound(eng, state0, state1, injected=None):
    """:func:`bound_ms` of :func:`k1_work`."""
    return bound_ms(*k1_work(eng, state0, state1, injected))


def k2_work(eng, state0, state1, cands, rows=None, sw=None):
    """(bytes, operations) of the K2 segment that took *state0* to
    *state1*: the candidates, y/u and the state read once, the state
    written once, and rows in: the rows read once, the solves of the steps
    each repetition ran; table in: the table and the factors *sw* read
    once, and per candidate and q point the blend besides the solve (a
    multiply-add per corner of the table's 2^A, the factor, the clamp and,
    for an amplitude table, the square; the worm's cross-section XS_OPS
    and the grid read once where the lookup has it)."""
    k, nq = eng.spec.k_cand, eng.consts.n
    n_bytes = 2 * _state_bytes(state0) + 2 * nq * 4 + cands.numel() * 4
    ops = SOLVE_OPS
    if rows is not None:
        n_bytes += rows.numel() * 4
    else:
        n_bytes += (eng.kern.table.values.numel() + sw.values.numel()) * 4
        ops += (2 ** len(eng.spec.table_layout) + 2
                + (not eng.kern.table_is_intensity))
        if eng.spec.factor_layout[0]:
            n_bytes += nq * 4
            ops += XS_OPS
    return n_bytes, _steps(eng, state0, state1) * k * nq * ops


def k2_bound(eng, state0, state1, cands, rows=None, sw=None):
    """:func:`bound_ms` of :func:`k2_work`."""
    return bound_ms(*k2_work(eng, state0, state1, cands, rows, sw))


def cyl_bank_work(inp, block_values=2 ** 24):
    """(bytes, operations) of one launch of the post pass's cylinder bank
    on *inp* (``ops.cyl_bank.BankInputs``): the inputs read once and the
    (B, Nq) bank written once; per contribution, point and offset the
    interior nodes, each on the branch of J1 its argument takes (the
    argument formed as the kernel forms it), and the two endpoints on
    their branches (j1_over_x's limit below 1e-6, sinc_sin's series below
    0.05); per output the three products of the weight.  Counted on the
    inputs' device, *block_values* nodes at a time."""
    nq, n_off = inp.grid.shape
    smeared = inp.smear_w is not None
    per_node = NODE_OPS + smeared
    ops = inp.radius.numel() * nq * 3
    block = max(1, block_values // max(1, nq * n_off * inp.x.numel()))
    for i in range(0, inp.radius.numel(), block):
        g = inp.grid[None]
        a = g * inp.radius[i:i + block, None, None]     # (b, Nq, n_off)
        c = g * inp.length[i:i + block, None, None]
        poly = int(((a[..., None] * inp.s).abs() <= 3.0).sum())
        nodes = a.numel() * inp.x.numel()
        ops += (nodes * per_node + poly * J1_POLY_OPS
                + (nodes - poly) * J1_ASYM_OPS)
        ops += _j1_over_x_ops(a.abs())
        series = int(((c * 0.5).abs() < 0.05).sum())
        ops += series * 5 + (a.numel() - series) * 2
        ops += a.numel() * (ENDS_OPS + smeared)
    return _bank_bytes(inp), ops


def _f64_bound(n_bytes, n_ops):
    """(ms, what bounds it): *n_bytes* over the HBM rate, *n_ops* float64
    operations over the float64 rate."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F64_OPS_PER_S
    return (max(t_b, t_o) * 1e3,
            "bytes" if t_b >= t_o else "float64 operations")


def _bank_bytes(inp) -> int:
    """A bank kernel's bytes: its inputs read once, the (B, Nq) bank
    written once."""
    import torch
    return 8 * (sum(t.numel() for t in inp if torch.is_tensor(t))
                + inp.radius.numel() * inp.grid.shape[0])


def _j1_over_x_ops(a) -> int:
    """The operations of j1_over_x on |x| = *a*: its limit below 1e-6,
    else the division and J1 on the branch x takes."""
    small = a < 1e-6
    return (int(small.sum()) * 3
            + int((~small & (a <= 3.0)).sum()) * (1 + J1_POLY_OPS)
            + int((a > 3.0).sum()) * (1 + J1_ASYM_OPS))


def cyl_bank_bound(inp):
    """:func:`_f64_bound` of :func:`cyl_bank_work`."""
    return _f64_bound(*cyl_bank_work(inp))


def kho_bank_work(inp, block_values=2 ** 24):
    """(bytes, operations) of one launch of the post pass's worm bank on
    *inp* (``ops.kho_bank.BankInputs``): the inputs read once and the
    (B, Nq) bank written once; per contribution its node arrays, each node
    on the branch its z takes; per contribution, point and offset the rule
    on the branch its t takes (the hyperbolic recurrence below 1, else the
    rotation, Filon's coefficients on the branch of F h and Si on the branch
    of F X), the tail where x > Z_CUT, and the cross-section on the branch
    its argument takes (j1_over_x's limit below 1e-6, J1's polynomial to
    3); per output the weight's product.  Each argument is formed as the
    kernel forms it; counted on the inputs' device, *block_values*
    elements at a time."""
    import torch
    from ..models import chains
    from ..ops import special
    nq, n_off = inp.grid.shape
    b, n2 = inp.radius.numel(), 2 * chains._N_HALF
    smeared = inp.smear_w is not None
    X = torch.clamp_max(inp.x, chains._Z_CUT)
    h = X / n2
    z = h[:, None] * torch.arange(n2 + 1, dtype=h.dtype, device=h.device)
    series = int((z < 0.1).sum())
    ops = (b * (KHO_SETUP_OPS + nq) + z.numel() * KHO_NODE_OPS
           + int((z > 0.0).sum()) * 2 + series * 6
           + (z.numel() - series) * 4)
    n_taylor, n_lag = len(special._SI_TAYLOR), len(special._SI_LAG_X)
    si_taylor = 2 + 2 * (n_taylor - 1)
    si_laguerre = 1 + 4 + 6 * (n_lag - 1) + 7
    n_tail = len(chains._TAIL_NODES)
    block = max(1, block_values // max(1, nq * n_off))
    for i in range(0, b, block):
        g = inp.grid[None]                              # (1, Nq, n_off)
        t = g * inp.kuhn[i:i + block, None, None] / 3.0
        xb = inp.x[i:i + block, None, None].expand_as(t)
        below = t < 1.0
        n, n_below = t.numel(), int(below.sum())
        ops += n * (KHO_ELEMENT_OPS + KHO_END_OPS + 2 * smeared)
        ops += n_below * (2 + KHO_SUB_STEP_OPS * n2)
        ops += (n - n_below) * (2 + KHO_SUP_STEP_OPS * n2
                                + KHO_ASSEMBLY_OPS)
        Xb = torch.clamp_max(xb, chains._Z_CUT)
        F = torch.sqrt(torch.clamp_min(t * t - 1.0, 1e-12))
        above = ~below
        th_small = int((above & (F * (Xb / n2) < 0.05)).sum())
        fx_small = int((above & (F * Xb < special._SI_CUT)).sum())
        ops += (th_small * KHO_FILON_SERIES_OPS
                + (n - n_below - th_small) * KHO_FILON_CLOSED_OPS
                + fx_small * si_taylor
                + (n - n_below - fx_small) * si_laguerre)
        tail = xb > chains._Z_CUT
        tail_below = int((tail & below).sum())
        tail_all = int(tail.sum())
        ops += (n + tail_all + tail_below * n_tail * KHO_TAIL_SUB_OPS
                + (tail_all - tail_below) * n_tail * KHO_TAIL_SUP_OPS)
        ops += _j1_over_x_ops((g * inp.radius[i:i + block, None, None])
                              .abs())
    return _bank_bytes(inp), ops


def kho_bank_bound(inp):
    """:func:`_f64_bound` of :func:`kho_bank_work`."""
    return _f64_bound(*kho_bank_work(inp))


# ------------------------------------------------------------ counting

def _wrappers():
    from ..ops import mc_kernel
    return {"K1": mc_kernel.run_chunk,
            "K2_table": mc_kernel.run_prefetch_table_chunk,
            "K2_rows": mc_kernel.run_prefetch_chunk}


def reset_launches() -> None:
    """Every chunk kernel wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def launches() -> dict:
    """The launches each chunk kernel wrapper counted since the last
    :func:`reset_launches`: K1 and K2's two entries."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def device_line(device) -> str:
    """The card's name and power limit (``nvidia-smi``) for a CUDA
    *device*, else the device's name: what goes beside every figure."""
    import torch
    if torch.device(device).type == "cuda":
        from ..utils.profiling import card_line
        return card_line()
    return str(device)


def synced_wall(fn, device="cuda"):
    """(fn's result, seconds on the host clock), a CUDA *device*
    synchronized before and after."""
    import torch

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over *reps* runs, with CUDA events, after
    one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ------------------------------------------------------------ workloads

def headline_workload(**kw):
    """(data, bound, cfg) of bench.py's headline (bench.py:259-262), with
    *kw* on top of its config."""
    from ..config import McSASConfig
    from ..data import load
    from ..models import get_model
    base = dict(num_contribs=300, num_reps=10, max_iterations=8_000_000,
                chunk_steps=2048, candidates_per_step=128, seed=2026,
                max_retries=1, local_moves=0.5)
    base.update(kw)
    return (load(_TESTDATA / "sasfit_sphere-10-1.dat"),
            get_model("Sphere").bind(), McSASConfig(**base))


def _engine_loop(eng, wrapper):
    """One warm-up run of *eng*, then one timed: (result, wall, launches
    of *wrapper* in the timed run)."""
    eng.run()
    reset_launches()
    res, wall = synced_wall(eng.run)
    return res, wall, wrapper.launches


def _rates(n_bytes, n_ops, ms):
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return {"bytes": n_bytes, "ops": n_ops,
            "bytes_per_sec": n_bytes / (ms * 1e-3),
            "pct_hbm_peak": 100.0 * n_bytes / (ms * 1e-3) / HBM_BYTES_PER_S,
            "ops_per_sec": n_ops / (ms * 1e-3),
            "pct_f32_peak": 100.0 * n_ops / (ms * 1e-3) / F32_OPS_PER_S,
            "bound_ms": b_ms, "bound_by": b_by,
            "pct_of_bound": 100.0 * b_ms / ms}


def fused_section(card: str) -> dict:
    """K1 at the headline shape (see the module's docstring)."""
    import torch

    from ..core.engine import McSASEngine
    from ..ops import mc_kernel
    data, bound, cfg = headline_workload(
        max_iterations=FUSED_BUDGET, convergence_criterion=0.0,
        max_retries=0, show_incomplete=True)
    eng = McSASEngine(data, bound, cfg, device="cuda")
    if not eng.runs_cuda_kernel or eng.runs_prefetch:
        raise AssertionError("the headline engine does not run K1")
    res, wall, chunks = _engine_loop(eng, mc_kernel.run_chunk)
    r, k = cfg.num_reps, cfg.candidates_per_step
    rep_steps = res.total_iters / k / r
    # the kernel alone: one chunk from a fresh state, repeated
    eng.gen.manual_seed(cfg.seed)
    state0 = eng._init_batch()
    work = state0.clone()
    ms = cuda_ms(lambda: mc_kernel.run_chunk(
        work.copy_(state0), 0, eng.consts, eng.spec, seed=cfg.seed,
        n_steps=cfg.chunk_steps), 10)
    n_bytes, n_ops = k1_work(eng, state0, work)
    props = torch.cuda.get_device_properties(0)
    return {
        "section": "fused-k1-sphere", "device": card,
        "shape": {"R": r, "K": k, "Nq": eng.consts.n,
                  "N": cfg.num_contribs, "chunk_steps": cfg.chunk_steps},
        "budget_per_attempt": FUSED_BUDGET, "chunks": chunks,
        "wall_s": wall, "total_proposals": res.total_iters,
        "steps_per_sec": rep_steps / wall,
        "us_per_step": wall * 1e6 / rep_steps,
        "proposals_per_sec": res.total_iters / wall,
        "ms_per_chunk": wall * 1e3 / chunks,
        "kernel_ms_per_chunk": ms,
        **_rates(n_bytes, n_ops, ms),
        "pct_of_bound_engine_loop": 100.0 * bound_ms(n_bytes, n_ops)[0]
        / (wall * 1e3 / chunks),
        "sms_occupied": r, "sm_count": props.multi_processor_count,
        "note": "one block a repetition: the launch occupies R SMs, and "
                "each block runs the chunk's dependent steps in sequence"}


def prefetch_section(card: str) -> dict:
    """K2 on the cylinder row (see the module's docstring)."""
    from ..core.engine import McSASEngine
    from ..ops import mc_kernel
    from . import suite
    golden, bound = suite.cylinder_golden(), suite.cylinder_bound()
    cfg = suite.cylinder_config()
    eng = McSASEngine(golden, bound, cfg, device="cuda")
    if eng.prefetch_entry != "table" or not eng.runs_cuda_kernel:
        raise AssertionError("the cylinder engine does not run K2's table "
                             "entry")
    s = eng.seg_steps
    eng.gen.manual_seed(cfg.seed)
    state0 = eng._init_batch()
    cands = mc_kernel.segment_candidates(state0, 0, eng.spec,
                                         eng._draw_chunk_proposals(s))
    sw = mc_kernel.table_factors(eng.spec, cands)
    rows = eng.kern.row(cands)
    work = state0.clone()
    c, sp = eng.consts, eng.spec
    entries = {}
    for entry, launch, kw in (
            ("table", lambda: mc_kernel.run_prefetch_table_chunk(
                work.copy_(state0), 0, c, sp, cands, sw), {"sw": sw}),
            ("rows", lambda: mc_kernel.run_prefetch_chunk(
                work.copy_(state0), 0, c, sp, rows, cands), {"rows": rows})):
        ms = cuda_ms(launch, 10)
        entries[entry] = {"ms_per_segment": ms, "us_per_step": ms * 1e3 / s,
                          **_rates(*k2_work(eng, state0, work, cands, **kw),
                                   ms)}
    loop = McSASEngine(golden, bound, cfg.replace(
        max_iterations=PREFETCH_BUDGET, convergence_criterion=0.0,
        max_retries=0), device="cuda")
    res, wall, segments = _engine_loop(loop,
                                       mc_kernel.run_prefetch_table_chunk)
    return {
        "section": "prefetch-k2-cylinder-table", "device": card,
        "shape": {"R": cfg.num_reps, "K": cfg.candidates_per_step,
                  "Nq": eng.consts.n, "S": s,
                  "table": list(eng.kern.table.values.shape)},
        "table_in": entries["table"], "rows_in": entries["rows"],
        "engine_loop": {
            "budget_per_attempt": PREFETCH_BUDGET, "segments": segments,
            "wall_s": wall, "ms_per_segment": wall * 1e3 / segments,
            "proposals_per_sec": res.total_iters / wall},
        "sms_occupied": cfg.num_reps,
        "note": "table in reads the table and the candidates' factors, "
                "rows in the staged (S, R, K, Nq) rows; one block a "
                "repetition"}


def kab_section(card: str) -> dict:
    """The headline fit at K=128 and K=256 (see the module's
    docstring)."""
    from ..api import fit
    rows = []
    for k in (128, 256):
        data, bound, cfg = headline_workload(candidates_per_step=k,
                                             max_iterations=KAB_BUDGET)
        fit(data, bound, cfg, device="cuda")             # warm-up
        wall, res = float("inf"), None
        for _ in range(2):
            out, dt = synced_wall(lambda: fit(data, bound, cfg,
                                              device="cuda"))
            if dt < wall:
                wall, res = dt, out
        rows.append({
            "K": k, "full_fit_s": wall,
            "converged_reps": int(res.engine.converged.sum()),
            "max_chi2": float(res.engine.conval.max()),
            "total_proposals": int(res.engine.total_iters),
            "proposals_per_sec": res.engine.iters_per_sec})
    adopt = (rows[1]["full_fit_s"] < rows[0]["full_fit_s"]
             and rows[1]["converged_reps"] >= rows[0]["converged_reps"])
    return {"section": "k-ab", "device": card, "rows": rows,
            "verdict": "adopt K=256" if adopt else "keep K=128"}


_SECTIONS = {"fused": fused_section, "prefetch": prefetch_section,
             "kab": kab_section}


def _names(text: str) -> list:
    names = [n for n in text.split(",") if n]
    bad = sorted(set(names) - set(SECTIONS))
    if bad:
        raise argparse.ArgumentTypeError(
            f"unknown section(s) {bad}; choose from {list(SECTIONS)}")
    return names


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mcsas_tpu_torch.tools.roofline",
        description=__doc__.split("\n")[0])
    ap.add_argument("--only", type=_names, action="extend", default=None,
                    help="comma-separated sections (repeatable): "
                         f"{','.join(SECTIONS)}; default: all three")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.profiling import card_line, require_card
    require_card("roofline")
    card = card_line()
    for name in SECTIONS:
        if args.only is None or name in args.only:
            print(json.dumps(_SECTIONS[name](card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
