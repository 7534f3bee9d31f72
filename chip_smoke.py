#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Chip smoke test of the PyTorch/CUDA port (mcsas_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):
  1. device: the card's name and power limit (nvidia-smi) and the
     torch/CUDA versions; fails when torch.cuda.is_available() is False;
  2. build: compiles csrc/mc_chunk.cu (K1), csrc/mc_prefetch.cu (K2) and
     csrc/mc_probe.cu (K3) with nvcc for sm_90a, one nvcc each, started
     together (timed; ptxas registers and spills printed); K1's launch
     shape for each model (lanes per candidate, threads per block,
     registers, spills) is printed where its engine is first built, K2's
     (with its row source and shared memory) in phase 6;
  3. K1 vs plain version: one 256-step chunk at the headline shape
     (R=10, N=300, K=128, local moves 0.5) on injected proposals — the
     accept decisions must be identical, or first differ at a near-tie
     (|Δχ²| ≤ 1e-6 relative, printed); ft = Σ bank (rtol 1e-5); χ² within
     1e-5 relative of the plain version's;
  4. Philox mode: one chunk drawing in-kernel — descent, parameters in
     range, every accepted proposal equal to the host model of the
     stream (so each repetition draws its own stream), and agreement
     with the plain version fed that host stream;
  5. the main path: ``fit()`` of Sphere on testdata/sasfit_sphere-10-1.dat
     with the headline config on device="cuda" — 10/10 repetitions
     converged, max χ² ≤ 1, the kernel's launch counter above 0, and the
     result held to the reference McSAS fixture of that dataset; the warm
     wall time of five fits;
  6. K2 vs its plain versions, both entries (rows in: the candidates'
     rows evaluated before the launch; table in: the row blend inside the
     kernel, the fit path): the cylinder suite row of bench.py (the
     synthetic cylinder golden, CylindersIsotropic on its 4096-row
     parameter table, R=10, N=300, K=128, Nq=100): one 131-step segment
     from a state initialized on the card, without and with local moves
     0.5 — every decision identical and every bit of the state equal
     afterwards (the bank holds the rows the kernel blended); then both
     entries at the ragged shapes K2_RAGGED (K1's, and a table of two
     axes), 64 steps each, both proposal modes; the table bake, both
     entries and their plain versions timed;
  7. the cylinder main path: ``fit()`` of that row on device="cuda" —
     10/10 converged, max χ² ≤ 1, K2's table entry launched, its rows
     entry and K1 not, two runs of one seed equal, the vol-weighted mean
     radius within 10 % of the golden 10 nm; one engine run allocates
     less than a segment's (S, R, K, Nq) rows would take (the table entry
     stages none); the warm wall time of five fits;
  8. K1 of LMADenseSphere, GaussianChain and SphericalCoreShell against
     its plain version at each suite row's shape (mcsas_tpu_torch/tools/
     suite.py): 256 steps with the row's active set and 64 with a second
     one, each on injected proposals and on the Philox stream (accepted
     proposals checked against the host stream in every column); K1 and
     the plain version timed on one 1024-step chunk; then K1 of all four
     models at the ragged shapes of its lane groups (RAGGED: K below, at
     and above the groups in flight, grids of 5 and 200 points, one
     repetition, a bank of one slot), 64 steps each, both proposal
     modes;
  9. the suite rows' main paths: ``fit()`` of each row on device="cuda"
     (300 × 10, chunk 1024, seed 2026) — 10/10 converged, max χ² ≤ 1,
     only K1 of the row's model launched, two runs of one seed equal,
     finite results, the vol-weighted mean of each parameter that
     generated the data within 10 % of its value; total_iters,
     proposals/s, the median warm wall of 3 fits;
 10. K3, the latency probe: its full rung bit for bit against K1 for
     every model and against both entries of K2, then every rung of
     every model (tools/kern_probe.py), the ff and solve rungs also at
     8, 16 and 32 lanes per candidate, and K2's rungs (loop, rows, solve,
     full) of both entries, one line each.

With ``--profile`` it also runs one more fit of each path under
torch.profiler and prints where the device time went and the device's
idle share, times both entries of K2 on shorter segments, the table
entry against the row lookup followed by the rows entry, and splits
three cylinder fits into set-up, MC run and post pass.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "testdata", "sasfit_sphere-10-1.dat")
FIXTURE = os.path.join(HERE, "testdata", "reference_sphere10_fixture.json")
NEAR_TIE = 1e-6
GOLDEN_RADIUS = 10e-9     # the synthetic cylinder's radius (aspect 10)


def headline_config(mcsas_config):
    """bench.py's headline workload (the JAX package's main path)."""
    return mcsas_config(num_contribs=300, num_reps=10,
                        max_iterations=8_000_000, chunk_steps=2048,
                        candidates_per_step=128, seed=2026, max_retries=1,
                        local_moves=0.5)


def cylinder_golden():
    """The synthetic cylinder golden of bench.py's suite row
    'cylinders-isotropic' (mcsas_tpu_torch/tools/suite.py)."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from mcsas_tpu_torch.tools import suite
    return suite.cylinder_golden()


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare_chunks(name, mc_kernel, ks, kt, ts, tt, rtol_chi=1e-5):
    """Kernel state/trace (ks, kt) against the plain version's (ts, tt).
    Returns (max |Δχ²| over the repetitions without a flip, or None when
    every repetition flips; flips {rep: first step})."""
    kc = kt["choice"].cpu().numpy()
    tc = tt["choice"].cpu().numpy()
    flips = {}
    for r in range(kc.shape[1]):
        diff = np.nonzero(kc[:, r] != tc[:, r])[0]
        if len(diff):
            s = int(diff[0])
            m = float(mc_kernel.decision_margin(tt["chi"][s, r],
                                                tt["conval"][s, r]))
            print(f"[{name}] rep {r}: first flip at step {s}: kernel k="
                  f"{kc[s, r]}, plain k={tc[s, r]}, current chi2 "
                  f"{float(tt['conval'][s, r])!r}, margin {m:.3g}")
            if not m <= NEAR_TIE:
                raise AssertionError(f"[{name}] rep {r} flips at step {s} "
                                     f"with margin {m:.3g} > {NEAR_TIE}")
            flips[r] = s
    same = [r for r in range(kc.shape[1]) if r not in flips]
    k_conv = ks.conval.double().cpu().numpy()
    t_conv = ts.conval.double().cpu().numpy()
    if same:
        idx = np.asarray(same)
        for field in ("n_moves", "n_iter"):
            a = getattr(ks, field).cpu().numpy()[idx]
            b = getattr(ts, field).cpu().numpy()[idx]
            if not np.array_equal(a, b):
                raise AssertionError(f"[{name}] {field} {a} != {b}")
        np.testing.assert_allclose(ks.rset.cpu().numpy()[idx],
                                   ts.rset.cpu().numpy()[idx], rtol=1e-6)
        np.testing.assert_allclose(k_conv[idx], t_conv[idx], rtol=rtol_chi)
    bank_sum = ks.ibank.double().sum(dim=1).cpu().numpy()
    np.testing.assert_allclose(ks.ft.double().cpu().numpy(), bank_sum,
                               rtol=1e-5, atol=1e-5 * np.abs(bank_sum).max())
    err = float(np.max(np.abs(k_conv - t_conv)[same])) if same else None
    print(f"[{name}] {len(same)}/{kc.shape[1]} repetitions identical in "
          f"every decision over {kc.shape[0]} steps; max |chi2 kernel - "
          f"plain| over them = {err!r} (tolerance 1e-5 relative); "
          f"ft = sum(bank) within 1e-5")
    return err, flips


def check_pair(name, mc_kernel, pair, steps, state0, n_reps):
    """Runs *pair(n)* — the kernel and its plain version over the first n
    steps from *state0*, returning (ks, kt, ts, tt) — over *steps* steps
    and compares them; after a near-tie flip, the window before the
    earliest flip is compared again on every repetition.  Returns (the
    window the error covers, max |Δχ²| over it, the kernel's state and
    trace of the whole run)."""
    ks, kt, ts, tt = pair(steps)
    err, flips = compare_chunks(name, mc_kernel, ks, kt, ts, tt)
    if ks.conval.gt(state0.conval).any():
        raise AssertionError(f"[{name}] the kernel raised a chi2")
    reps = n_reps - len(flips)
    if flips:
        first = min(flips.values())
        if first < 1:
            raise AssertionError(f"[{name}] flip at the first step")
        err, again = compare_chunks(f"{name}, first {first} steps",
                                    mc_kernel, *pair(first))
        if again:
            raise AssertionError(f"[{name}] flips before step {first}")
        steps, reps = first, n_reps
    if err is None:
        raise AssertionError(f"[{name}] no repetition left to compare")
    window = {"mode": name, "steps": steps, "reps": reps}
    return window, err, ks, kt


def check_philox_stream(name, eng, state0, host, ps, pt, need=True):
    """Every proposal the kernel accepted in Philox mode (state *ps*,
    trace *pt*, from *state0*) equals the host model of the stream
    *host*, in every parameter column: global columns exactly, local
    moves to 1e-6 relative (exp on the host).  The chunk must be at most
    N steps long, so that each slot is visited once.  With *need*, a
    chunk that accepted nothing fails."""
    lo, hi = (np.asarray(v, np.float32) for v in zip(*eng.bound.ranges))
    rset = ps.rset.cpu().numpy()
    choice = pt["choice"].cpu().numpy()
    cur0 = state0.rset.cpu().numpy()
    k_glob = eng.spec.k_global
    checked = 0
    for s, r in zip(*np.nonzero(choice >= 0)):
        k = int(choice[s, r])
        slot = s % eng.cfg.num_contribs
        got = rset[r, slot]
        if k < k_glob:
            want = host[s, r, k]
            ok = np.array_equal(got, want)
        else:
            f = np.exp((2.0 * host[s, r, k] - 1.0) * eng.cfg.local_scale)
            want = np.clip(cur0[r, slot] * f, lo, hi)
            ok = np.all(np.abs(got - want) <= 1e-6 * np.abs(want))
        if not ok:
            raise AssertionError(f"[{name}] step {s} rep {r} k={k}: kernel "
                                 f"accepted {got!r}, host stream {want!r}")
        checked += 1
    if need and not checked:
        raise AssertionError(f"[{name}] the kernel accepted nothing")
    print(f"[{name}] {checked} accepted proposals equal the host model of "
          f"the stream in all {rset.shape[2]} parameter column(s); reps "
          f"draw distinct streams", flush=True)


def time_chunk(torch, fn, reps):
    """Mean milliseconds of fn() over *reps* runs, with CUDA events, after
    one warm-up run."""
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


def profile_fit(torch, run, card, label, kernel):
    """``--profile``: one more warm fit under torch.profiler.  Prints the
    device's busy time (the sum of its kernels' self times), the chunk
    kernel's part of it (*kernel*: a name fragment), the idle share of
    the fit's wall time (the fit runs on one stream, so kernels do not
    overlap) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((us, ev.count, ev.key))
    if not rows:
        raise AssertionError("[profile] the profiler saw no device time")
    rows.sort(reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e6
    k1 = [(us, n) for us, n, key in rows if kernel in key]
    k1_ms = sum(us for us, _ in k1) / 1e3
    k1_n = sum(n for _, n in k1)
    print(f"[profile] one warm {label} fit under torch.profiler, {card}: "
          f"wall {wall:.4f} s; device busy {busy * 1e3:.2f} ms "
          f"({busy / wall:.1%}), idle {1 - busy / wall:.1%}; {kernel} "
          f"{k1_ms:.2f} ms in {k1_n} launches; other kernels "
          f"{busy * 1e3 - k1_ms:.2f} ms", flush=True)
    for us, n, key in rows[:8]:
        print(f"[profile] {us / 1e3:10.3f} ms {n:6d}x  {key[:80]}")


def fit_phases(torch, engine_cls, histogram_all, data, bound, cfg, card):
    """``--profile``: the host-clock split of three warm fits into what
    ``api.fit`` runs — engine set-up, the MC run, the float64 post pass
    with the histograms."""
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = engine_cls(data, bound, cfg, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        histogram_all(res.contribs, data, bound, cfg, None,
                      device=eng.device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        print(f"[profile] cylinder fit phases, {card}: set-up "
              f"{(t1 - t0) * 1e3:.2f} ms, run {(t2 - t1) * 1e3:.2f} ms, "
              f"post pass and histograms {(t3 - t2) * 1e3:.2f} ms",
              flush=True)


# the work of a chunk kernel, for its bound (PERF.md §6): the
# operations per candidate and q point -- the row of each model (every
# +, -, *, /, sqrt, sin, cos, exp and pow counted as one, so a lower
# bound) and the two passes of the solve (the float64 adds priced at the
# float32 rate, which keeps the bound a lower one)
ROW_OPS = {"Sphere": 12, "LMADenseSphere": 55, "GaussianChain": 14,
           "SphericalCoreShell": 25}
SOLVE_OPS = 14
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores, ditto
# the second active set of each suite row: what the row fits, fixed
SECOND_ACTIVE = {"gaussian-chain": ("bp",),
                 "core-shell-sphere": ("radius",),
                 "lma-dense-sphere": ("radius",)}
# total_iters of the JAX package's TPU round (BENCHMARKS.md:51-61): counts
JAX_TOTAL_ITERS = {"gaussian-chain": 1_619_200,
                   "core-shell-sphere": 17_836_544,
                   "lma-dense-sphere": 3_389_056}
STATE_FIELDS = ("rset", "ibank", "ft", "scale", "background", "conval",
                "n_iter", "n_moves")
# K1's ragged shapes, (repetitions, K, fit-grid bins, contributions): K
# below, at and above the 128 groups of 8 lanes a block holds, grids
# smaller than a group and longer than the 104 points a group keeps in
# registers, one repetition, and a bank of one slot
RAGGED = {"r1-k8-bins5": (1, 8, 5, 64),
          "r2-k64-bins100": (2, 64, 100, 64),
          "r2-k200-bins200": (2, 200, 200, 64),
          "r2-k8-bins100-n1": (2, 8, 100, 1)}


def ptxas_spills(log):
    """{kernel's mangled name: its ptxas line of stack frame and spills}
    from an nvcc -Xptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            out[name] = line.strip()
            name = None
    return out


def print_k1_shape(mc_kernel, eng, state, spills, card):
    """K1's launch shape for an engine: lanes per candidate, threads per
    block, registers and local memory per thread, and ptxas's spills of
    the instantiation that runs.  Returns the shape."""
    shape = mc_kernel.launch_shape(state, eng.consts, eng.spec)
    mid = mc_kernel.model_id(eng.bound.model)
    name = (f"_Z15mc_chunk_kernelILi{mid}ELi5ELi{shape['group']}"
            f"EEv11ChunkParams")
    print(f"[shape] K1 {eng.bound.model.name} at K={eng.spec.k_cand} "
          f"Nq={eng.consts.n}: {shape['group']} lanes per candidate, "
          f"{shape['threads']} threads per block, {shape['registers']} "
          f"registers and {shape['local_bytes']} B local memory per thread;"
          f" ptxas: {spills.get(name, 'not found')}; {card}", flush=True)
    return shape


def reset_counts(mc_kernel):
    """Every kernel wrapper's launch count to 0."""
    mc_kernel.run_chunk.launches = 0
    mc_kernel.run_chunk.model_launches = {}
    mc_kernel.run_prefetch_chunk.launches = 0
    mc_kernel.run_prefetch_table_chunk.launches = 0
    mc_kernel.run_probe.launches = 0


def bound_ms(n_bytes, n_ops):
    """(ms, what bounds it): the least time the card could take to move
    *n_bytes* and do *n_ops* float32 operations."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _state_bytes(state):
    return sum(getattr(state, f).numel() * getattr(state, f).element_size()
               for f in STATE_FIELDS)


def k1_bound(eng, state0, state1, injected=None):
    """bound_ms of the K1 chunk that took *state0* to *state1*: the state
    read and written once, q/y/u and any *injected* proposals read once;
    the rows and solves of the steps each repetition ran (its n_iter
    grows by K per step it ran)."""
    k, nq = eng.spec.k_cand, eng.consts.n
    steps = int((state1.n_iter - state0.n_iter).sum()) // k
    n_bytes = 2 * _state_bytes(state0) + 3 * nq * 4
    if injected is not None:
        n_bytes += injected.numel() * 4
    ops = steps * k * nq * (ROW_OPS[eng.bound.model.name] + SOLVE_OPS)
    return bound_ms(n_bytes, ops)


def k2_bound(eng, state0, state1, cands, rows=None, sw=None):
    """bound_ms of the K2 segment that took *state0* to *state1*: the
    candidates, y/u and the state read once, the state written once, and
    rows in: the rows read once, the solves of the steps each repetition
    ran; table in: the table and *sw* read once, and per candidate and q
    point the blend besides the solve (a multiply-add per corner of the
    table's 2^A, the amplitude factor, the square and the clamp) — the
    same work whatever implements it."""
    k, nq = eng.spec.k_cand, eng.consts.n
    steps = int((state1.n_iter - state0.n_iter).sum()) // k
    n_bytes = 2 * _state_bytes(state0) + 2 * nq * 4 + cands.numel() * 4
    ops = SOLVE_OPS
    if rows is not None:
        n_bytes += rows.numel() * 4
    else:
        n_bytes += (eng.kern.table.values.numel() + sw.numel()) * 4
        ops += 2 ** len(eng.spec.table_layout) + 3
    return bound_ms(n_bytes, steps * k * nq * ops)


# K2's ragged shapes: K1's (K = 200 at 200 bins is also more than two
# staged blocks of rows may take of the shared memory, so its rows are
# read from global memory, and its corner rows from the table), and a
# table of two axes (radius and aspect active)
K2_RAGGED = dict(RAGGED, **{"r3-k48-bins100-2axes": (3, 48, 100, 64)})


def states_equal(torch, name, a, b):
    """Every field of two states equal bit for bit, or raises."""
    for f in STATE_FIELDS:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"[{name}] the kernel's {f} differs from "
                                 "the plain version's")


def k2_entries(mc_kernel, eng, cands):
    """{entry: (kernel(state, ri, n, trace), plain(state, ri, n, trace))}
    of K2's two entries over the first n steps of *cands*: 'rows' on the
    rows the engine's lookup gives, 'table' on the table and sqrt(w)."""
    rows = eng.kern.row(cands)
    sw = mc_kernel.sqrt_weights(eng.spec, cands)
    c, sp = eng.consts, eng.spec
    return rows, sw, {
        "rows": (
            lambda st, ri, n, tr=None: mc_kernel.run_prefetch_chunk(
                st, ri, c, sp, rows[:n], cands[:n], trace=tr),
            lambda st, ri, n, tr=None: mc_kernel.prefetch_reference(
                st, ri, c, sp, rows[:n], cands[:n], trace=tr)),
        "table": (
            lambda st, ri, n, tr=None: mc_kernel.run_prefetch_table_chunk(
                st, ri, c, sp, cands[:n], sw[:n], trace=tr),
            lambda st, ri, n, tr=None: mc_kernel.prefetch_table_reference(
                st, ri, c, sp, cands[:n], trace=tr))}


def check_k2(torch, mc_kernel, name, eng, state0, cands, need=True):
    """Both entries of K2 against their plain versions over the segment
    *cands* from *state0*: every decision identical (check_pair), then
    every bit of the state.  Returns (rows, sw, entries, windows, errs)."""
    rows, sw, entries = k2_entries(mc_kernel, eng, cands)
    steps = int(cands.shape[0])
    windows, errs = [], []
    for entry, (kernel, plain) in entries.items():
        def pair(n, kernel=kernel, plain=plain):
            ks, kt, ts, tt = state0.clone(), {}, state0.clone(), {}
            kernel(ks, 0, n, kt)
            plain(ts, 0, n, tt)
            torch.cuda.synchronize()
            if n == steps and torch.equal(kt["choice"], tt["choice"]):
                states_equal(torch, f"{name} {entry} in", ks, ts)
            return ks, kt, ts, tt

        win, err, ks, _ = check_pair(f"{name} {entry} in", mc_kernel, pair,
                                     steps, state0, eng.cfg.num_reps)
        if need and not (ks.n_moves > 0).all():
            raise AssertionError(f"[{name} {entry} in] a repetition "
                                 "accepted nothing")
        windows.append(dict(win, entry=entry))
        errs.append(err)
    return rows, sw, entries, windows, errs


def check_k2_ragged(torch, mc_kernel, engine_cls, load, data_config,
                    get_model, cyl_cfg, card):
    """Both entries of K2 against their plain versions at the K2_RAGGED
    shapes, 64 steps each (with local moves at most N, a segment visiting
    each slot once), without and with local moves: the cylinder model on
    the headline data rebinned to the shape's bins, its table baked at
    that grid.  Returns the compared windows and the largest |delta
    chi2|."""
    windows, worst = [], 0.0
    for label, (reps, k, n_bin, n) in K2_RAGGED.items():
        two = label.endswith("2axes")
        bound = get_model("CylindersIsotropic").bind(
            active=("radius", "aspect") if two else ("radius",),
            active_ranges=dict({"radius": (1e-10, 5e-8)},
                               **({"aspect": (1.0, 30.0)} if two else {})))
        data = load(DATA, config=data_config(n_bin=n_bin))
        for local in (0.0, 0.5):
            eng = engine_cls(data, bound, cyl_cfg.replace(
                num_contribs=n, num_reps=reps, candidates_per_step=k,
                local_moves=local), device="cuda")
            eng.gen.manual_seed(5)
            state0 = eng._init_batch()
            steps = min(64, n) if local else 64
            cands = mc_kernel.segment_candidates(
                state0, 0, eng.spec, eng._draw_chunk_proposals(steps))
            rows, _, _, win, errs = check_k2(
                torch, mc_kernel, f"K2 {label} local_moves={local}", eng,
                state0, cands, need=False)
            windows += win
            worst = max(worst, *errs)
        for r_ in (rows, None):
            shape = mc_kernel.prefetch_launch_shape(
                state0, eng.consts, eng.spec, cands, r_)
            print(f"[shape] K2 {'rows' if r_ is not None else 'table'} in "
                  f"at {label} (K={k} Nq={eng.consts.n}, "
                  f"{len(eng.spec.table_layout)} table axes): {shape}; "
                  f"{card}", flush=True)
    return windows, worst


def compare_on(torch, mc_kernel, name, eng, state0, steps, seed,
               need=True):
    """K1 against its plain version over *steps* steps from *state0*, on
    the engine's own proposals and on the Philox stream *seed* (where the
    chunk visits each slot at most once, its accepted proposals checked
    against the host stream; with *need* it must have accepted some).
    Returns the compared windows and the largest |delta chi2|."""
    def pair(props, phx=None):
        ks, kt = state0.clone(), {}
        if phx is None:
            mc_kernel.run_chunk(ks, 0, eng.consts, eng.spec,
                                proposals=props, trace=kt)
        else:
            mc_kernel.run_chunk(ks, 0, eng.consts, eng.spec, seed=phx,
                                n_steps=props.shape[0], trace=kt)
        ts, tt = state0.clone(), {}
        mc_kernel.chunk_reference(ts, 0, eng.consts, eng.spec, props,
                                  trace=tt)
        torch.cuda.synchronize()
        return ks, kt, ts, tt

    r = eng.cfg.num_reps
    props = eng._draw_chunk_proposals(n_steps=steps)
    win_i, err_i, _, _ = check_pair(f"{name} injected", mc_kernel,
                                    lambda n: pair(props[:n]), steps,
                                    state0, r)
    host = mc_kernel.philox_proposals(eng.spec, seed, r, steps,
                                      device="cuda")
    hp = torch.as_tensor(host, device="cuda")
    win_p, err_p, ps, pt = check_pair(f"{name} philox", mc_kernel,
                                      lambda n: pair(hp[:n], seed), steps,
                                      state0, r)
    if steps <= eng.cfg.num_contribs:
        check_philox_stream(f"{name} philox", eng, state0, host, ps, pt,
                            need)
    return [win_i, win_p], max(err_i, err_p)


def check_k1_row(torch, mc_kernel, engine_cls, row, spills, card):
    """K1 of one suite row's model against its plain version: 256 steps
    at the row's shape (R=10, N=300, its K and local moves) and 64 steps
    with the second active set, each on injected proposals and on the
    Philox stream; then K1 and the plain version timed on one 1024-step
    chunk (the row's chunk) with CUDA events.  Returns the kernel line's
    numbers."""
    data = row.load()
    cfg = row.config()
    windows, errs = [], []
    for label, active, steps in (("suite", None, 256),
                                 ("second", SECOND_ACTIVE[row.name], 64)):
        eng = engine_cls(data, row.bound(data, active), cfg, device="cuda")
        if not eng.runs_cuda_kernel:
            raise AssertionError(f"{row.name}: the engine does not use K1")
        eng.gen.manual_seed(1)
        state0 = eng._init_batch()
        name = f"{row.model} {label} {'+'.join(eng.bound.active)}"
        if eng.spec.model_layout[2] is not None:
            name += " (fixed volume)"
        # GaussianChain with bp alone active: every row has the shape of
        # the fixed rg, the fitted scale absorbs bp, and chi2 moves only
        # by rounding, so that set may accept nothing
        win, err = compare_on(torch, mc_kernel, name, eng, state0, steps,
                              20261016 + steps, need=label == "suite")
        windows += win
        errs.append(err)
        if label == "suite":
            suite_eng, suite_state0 = eng, state0
            shape = print_k1_shape(mc_kernel, eng, state0, spills, card)
    eng, state0 = suite_eng, suite_state0
    work = state0.clone()
    props = eng._draw_chunk_proposals(n_steps=cfg.chunk_steps)

    def kernel():
        mc_kernel.run_chunk(work.copy_(state0), 0, eng.consts, eng.spec,
                            seed=7, n_steps=cfg.chunk_steps)

    def plain():
        mc_kernel.chunk_reference(work.copy_(state0), 0, eng.consts,
                                  eng.spec, props)

    ms = time_chunk(torch, kernel, 5)
    b_ms, b_by = k1_bound(eng, state0, work)
    plain_ms = time_chunk(torch, plain, 1)
    print(f"[time] {row.model}: {cfg.chunk_steps}-step chunk at R=10 "
          f"N=300 K={eng.spec.k_cand} Nq={eng.consts.n} (reset copy "
          f"included), {card}: kernel Philox {ms:.3f} ms "
          f"({ms * 1e3 / cfg.chunk_steps:.2f} us per step), plain PyTorch "
          f"{plain_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, compared=windows, shape=shape)


def check_k1_ragged(torch, mc_kernel, engine_cls, load, mcsas_config,
                    data_config, get_model, spills, card):
    """K1 of every model against its plain version at the RAGGED shapes,
    64 steps each, on injected proposals and on the Philox stream (each
    model on its suite row's data and active set, Sphere on the headline
    data, the grid rebinned to the shape's bins).  Returns the compared
    windows and the largest |delta chi2| of each model."""
    from mcsas_tpu_torch.tools.suite import ROWS
    windows, errs = [], {}
    for model in mc_kernel.K1_MODELS:
        row = next((r for r in ROWS.values() if r.model == model.name),
                   None)
        for label, (reps, k, n_bin, n) in RAGGED.items():
            if row is None:
                data = load(DATA, config=data_config(n_bin=n_bin))
                bound = get_model("Sphere").bind()
                cfg = headline_config(mcsas_config)
            else:
                data = row.load()
                data = data.with_config(data.config.replace(n_bin=n_bin))
                bound = row.bound(data)
                cfg = row.config()
            cfg = cfg.replace(num_contribs=n, num_reps=reps,
                              candidates_per_step=k)
            eng = engine_cls(data, bound, cfg, device="cuda")
            eng.gen.manual_seed(5)
            state0 = eng._init_batch()
            shape = print_k1_shape(mc_kernel, eng, state0, spills, card)
            name = (f"{model.name} {label} ({shape['group']} lanes x "
                    f"{shape['threads'] // shape['group']} groups)")
            win, err = compare_on(torch, mc_kernel, name, eng, state0, 64,
                                  20261017, need=False)
            windows += win
            errs[model.name] = max(errs.get(model.name, 0.0), err)
    return windows, errs


def fit_row(torch, mc_kernel, fit, row, card, profiling):
    """The suite row's full-width fit on the card: one cold fit, then
    three timed warm ones, the launch counts taken over the first of
    them (with *profiling*, one more under torch.profiler).  Gates: 10/10
    converged, max chi2 <= 1, K1 launched for the row's model and nothing
    else, the cold and warm runs of one seed equal, finite values of the
    expected shape.  Returns the model's K1 launches."""
    data = row.load()
    bound = row.bound(data)
    cfg = row.config()

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit(data, bound, cfg, device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    first = fit(data, bound, cfg, device="cuda")
    reset_counts(mc_kernel)
    res, wall = timed()
    launches = mc_kernel.run_chunk.model_launches.get(row.model, 0)
    others = (mc_kernel.run_chunk.launches - launches
              + mc_kernel.run_prefetch_chunk.launches)
    walls = [wall] + [timed()[1] for _ in range(2)]
    e = res.engine
    for r_ in (first, res):
        if not (r_.engine.converged.all() and r_.engine.conval.max() <= 1.0):
            raise AssertionError(
                f"[fit {row.name}] {int(r_.engine.converged.sum())}/10 "
                f"converged, max chi2 {r_.engine.conval.max()}")
    if launches <= 0 or others or not e.used_pallas or e.used_table:
        raise AssertionError(f"[fit {row.name}] {launches} K1 launches of "
                             f"{row.model}, {others} other launches")
    if not np.array_equal(first.engine.contribs, e.contribs):
        raise AssertionError(f"[fit {row.name}] two runs of one seed "
                             "differ")
    p = bound.n_active
    if not (e.contribs.shape == (10, 300, p)
            and np.isfinite(e.contribs).all()
            and np.isfinite(res.fractions.measval).all()
            and res.fractions.measval.shape == (10, data.count)):
        raise AssertionError(f"[fit {row.name}] wrong shape or non-finite "
                             "values")
    means = {h.spec.param: float(h.moments.mean[0]) for h in res.histograms
             if h.spec.yweight == "vol"}
    if set(means) != set(bound.active) or not all(
            np.isfinite(v) for v in means.values()):
        raise AssertionError(f"[fit {row.name}] vol-weighted means {means}")
    # the data's generating parameters (q read in nm⁻¹): within 10 %
    for name, want in row.truth.items():
        if not abs(means[name] - want) <= 0.1 * want:
            raise AssertionError(f"[fit {row.name}] vol-weighted mean "
                                 f"{name} {means[name]!r}, generating "
                                 f"value {want!r}")
    print(f"[fit {row.name}] 10/10 converged, max chi2 "
          f"{e.conval.max():.4f}, {launches} K1 launches, total_iters "
          f"{e.total_iters} (the JAX package's TPU round: "
          f"{JAX_TOTAL_ITERS[row.name]:,}, a count), "
          f"{e.total_iters / e.elapsed:.4g} proposals/s, warm walls "
          f"{walls}, median {float(np.median(walls)):.4f} s; vol-weighted "
          f"means {means} (generating values {row.truth}, within 10 %); "
          f"on {card}", flush=True)
    if profiling:
        profile_fit(torch, lambda: fit(data, bound, cfg, device="cuda"),
                    card, row.name, "mc_chunk")
    return launches


def probe_phase(torch, mc_kernel, card):
    """K3: its full rung bit for bit against K1 on the same injected
    proposals, for each model (256 steps at the headline shape), and
    against both entries of K2 (one 131-step segment of the cylinder
    row); then every rung of every model and of K2's two entries through
    the probe's runner, its launches counted over that run; and the plain
    version of the Sphere full rung timed on the same 2048 steps.
    Returns the kernel line's numbers."""
    from mcsas_tpu_torch.tools import kern_probe
    err = 0.0
    for m in mc_kernel.K1_MODELS:
        eng = kern_probe.probe_engine(m.name)
        eng.gen.manual_seed(4)
        state0 = eng._init_batch()
        props = eng._draw_chunk_proposals(n_steps=256)
        a, b = state0.clone(), state0.clone()
        mc_kernel.run_chunk(a, 0, eng.consts, eng.spec, proposals=props)
        mc_kernel.run_probe(b, 0, eng.consts, eng.spec, "full",
                            proposals=props)
        torch.cuda.synchronize()
        for f in STATE_FIELDS:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"[probe] full rung of {m.name} "
                                     f"differs from K1 in {f}")
        err = max(err, float((a.conval - b.conval).abs().max()))
        if not (a.n_moves > 0).all():
            raise AssertionError(f"[probe] {m.name}: K1 accepted nothing")
    print(f"[probe] full rung equal to K1 bit for bit in every state field "
          f"over 256 injected steps, all {len(mc_kernel.K1_MODELS)} models",
          flush=True)
    from mcsas_tpu_torch.tools import suite
    from mcsas_tpu_torch.core.engine import McSASEngine
    eng = McSASEngine(suite.cylinder_golden(), suite.cylinder_bound(),
                      suite.cylinder_config(local_moves=0.5), device="cuda")
    eng.gen.manual_seed(4)
    state0 = eng._init_batch()
    cands = mc_kernel.segment_candidates(
        state0, 0, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    rows, sw, entries = k2_entries(mc_kernel, eng, cands)
    for entry, (kernel, _) in entries.items():
        a, b = state0.clone(), state0.clone()
        kernel(a, 0, eng.seg_steps)
        mc_kernel.run_prefetch_probe(
            b, 0, eng.consts, eng.spec, "full", cands,
            rows if entry == "rows" else None,
            sw if entry == "table" else None)
        torch.cuda.synchronize()
        states_equal(torch, f"probe, K2 {entry} in, full rung", a, b)
        if not (a.n_moves > 0).all():
            raise AssertionError(f"[probe] K2 {entry} in accepted nothing")
    del rows, entries
    print(f"[probe] full rung equal to K2 bit for bit in every state field "
          f"over one {eng.seg_steps}-step segment, both entries",
          flush=True)
    print(f"[probe] the rungs, one JSON line each, on {card}:", flush=True)
    reset_counts(mc_kernel)
    recs = kern_probe.run(launches=3) + kern_probe.run_prefetch(launches=3)
    launches = mc_kernel.run_probe.launches
    if launches != len(recs) * 4:
        raise AssertionError(f"[probe] {launches} launches for "
                             f"{len(recs)} rungs")
    full = next(r for r in recs
                if r["level"] == "full" and r["model"] == "Sphere")
    eng = kern_probe.probe_engine("Sphere")
    eng.gen.manual_seed(1)
    state0 = eng._init_batch()
    work = state0.clone()
    props = eng._draw_chunk_proposals(n_steps=kern_probe.CHUNK)

    def plain():
        mc_kernel.chunk_reference(work.copy_(state0), 0, eng.consts,
                                  eng.spec, props)

    plain_ms = time_chunk(torch, plain, 1)
    # the work of one full-rung launch, from a run of K1 on that state
    mc_kernel.run_chunk(work.copy_(state0), 0, eng.consts, eng.spec,
                        seed=kern_probe.SEED, n_steps=kern_probe.CHUNK)
    torch.cuda.synchronize()
    b_ms, b_by = k1_bound(eng, state0, work)
    return dict(launches=launches, max_abs_err=err,
                ms=full["ms_per_launch"], plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, rungs=recs)


def main():
    import torch
    profiling = "--profile" in sys.argv[1:]
    # ---- phase 1: device
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    sys.path.insert(0, HERE)
    from mcsas_tpu_torch import fit, load
    from mcsas_tpu_torch.config import McSASConfig
    from mcsas_tpu_torch.core.engine import McSASEngine
    from mcsas_tpu_torch.data import DataConfig
    from mcsas_tpu_torch.models import get_model
    from mcsas_tpu_torch.ops import mc_kernel
    from mcsas_tpu_torch.post.histogram import HistogramSpec, histogram_all

    # ---- phase 2: build (one nvcc per kernel source, in parallel)
    t0 = time.perf_counter()
    builds = mc_kernel.build_libraries()
    build_wall = time.perf_counter() - t0
    for name, build in builds.items():
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas [{name}]:", line.strip())
        mc_kernel._library(name)
        print(f"[build] {build.path.name}: nvcc {build.seconds:.2f} s",
              flush=True)
    print(f"[build] {len(builds)} kernels in {build_wall:.2f} s wall",
          flush=True)
    spills = ptxas_spills(builds["mc_chunk"].log)

    # ---- phase 3: kernel against the plain version, injected proposals
    cfg = headline_config(McSASConfig)
    data = load(DATA)
    eng = McSASEngine(data, get_model("Sphere").bind(), cfg, device="cuda")
    if not eng.runs_cuda_kernel:
        raise AssertionError("the headline engine does not use the kernel")
    eng.gen.manual_seed(1)
    state0 = eng._init_batch()
    k1_shape = print_k1_shape(mc_kernel, eng, state0, spills, card)

    def pair(props, seed=None):
        """One chunk of the kernel (injected *props*, or Philox *seed*)
        and of the plain version on *props*, from the same state."""
        ks, kt = state0.clone(), {}
        if seed is None:
            mc_kernel.run_chunk(ks, 0, eng.consts, eng.spec,
                                proposals=props, trace=kt)
        else:
            mc_kernel.run_chunk(ks, 0, eng.consts, eng.spec, seed=seed,
                                n_steps=props.shape[0], trace=kt)
        ts, tt = state0.clone(), {}
        mc_kernel.chunk_reference(ts, 0, eng.consts, eng.spec, props,
                                  trace=tt)
        torch.cuda.synchronize()
        return ks, kt, ts, tt

    def check(name, props, seed=None):
        """Compares a 256-step chunk (see check_pair)."""
        return check_pair(name, mc_kernel, lambda n: pair(props[:n], seed),
                          int(props.shape[0]), state0, cfg.num_reps)

    win_inj, err_inj, _, _ = check("injected",
                                   eng._draw_chunk_proposals(n_steps=256))

    # ---- phase 4: Philox mode
    seed = 20261016
    host = mc_kernel.philox_proposals(eng.spec, seed, cfg.num_reps, 256,
                                      device="cuda")
    if np.array_equal(host[:, 0], host[:, 1]):
        raise AssertionError("repetitions 0 and 1 share a Philox stream")
    win_phx, err_phx, ps, pt = check(
        "philox", torch.as_tensor(host, device="cuda"), seed=seed)
    lo, hi = eng.bound.ranges[0]
    rset = ps.rset.cpu().numpy()
    if not (rset.min() >= np.float32(lo) and rset.max() <= np.float32(hi)):
        raise AssertionError("Philox chunk left the active range")
    if not ((ps.conval < state0.conval).all() and (ps.n_moves > 0).all()):
        raise AssertionError("Philox chunk did not descend in every rep")
    check_philox_stream("philox", eng, state0, host, ps, pt)

    # per-chunk times at the main path's chunk (2048 steps), CUDA events
    props_full = eng._draw_chunk_proposals()
    steps = cfg.chunk_steps
    work = state0.clone()

    def kernel_philox():
        mc_kernel.run_chunk(work.copy_(state0), 0, eng.consts, eng.spec,
                            seed=seed, n_steps=steps)

    def kernel_injected():
        mc_kernel.run_chunk(work.copy_(state0), 0, eng.consts, eng.spec,
                            proposals=props_full)

    def plain():
        mc_kernel.chunk_reference(work.copy_(state0), 0, eng.consts,
                                  eng.spec, props_full)

    ms_philox = time_chunk(torch, kernel_philox, 5)
    k1_bound_ms, k1_bound_by = k1_bound(eng, state0, work)
    ms_injected = time_chunk(torch, kernel_injected, 5)
    ms_plain = time_chunk(torch, plain, 2)
    print(f"[time] {steps}-step chunk at R=10 N=300 K=128 Nq={data.count} "
          f"(reset copy included), {card}: kernel Philox {ms_philox:.3f} "
          f"ms, kernel injected {ms_injected:.3f} ms, plain PyTorch "
          f"{ms_plain:.3f} ms", flush=True)

    # ---- phase 5: the main path
    def timed_fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit(DATA, "Sphere", cfg, device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    first = fit(DATA, "Sphere", cfg, device="cuda")       # cold
    reset_counts(mc_kernel)
    res, wall = timed_fit()
    launches = mc_kernel.run_chunk.launches
    if (mc_kernel.run_prefetch_chunk.launches
            or mc_kernel.run_chunk.model_launches != {"Sphere": launches}):
        raise AssertionError("the Sphere main path launched another "
                             "kernel")
    walls = [wall] + [timed_fit()[1] for _ in range(4)]
    e = res.engine
    for r_ in (first, res):
        if not (r_.engine.converged.all() and r_.engine.conval.max() <= 1.0):
            raise AssertionError(
                f"main path: {int(r_.engine.converged.sum())}/10 converged,"
                f" max chi2 {r_.engine.conval.max()}")
    if launches <= 0 or not e.used_pallas:
        raise AssertionError("main path did not launch the CUDA kernel")
    if not np.array_equal(first.engine.contribs, e.contribs):
        raise AssertionError("two runs of one seed differ")
    if not (e.contribs.shape == (10, 300, 1)
            and np.isfinite(e.contribs).all()
            and np.isfinite(res.fractions.measval).all()
            and res.fractions.measval.shape == (10, data.count)):
        raise AssertionError("main path result has the wrong shape or "
                             "non-finite values")
    # the repo's own yardstick: the reference McSAS fit of this dataset
    with open(FIXTURE, encoding="utf-8") as fd:
        fix = json.load(fd)
    lo_f, hi_f = fix["workload"]["activeRange_m"]
    y_ref = np.asarray(fix["histograms"]["vol"]["yMean"])
    spec = HistogramSpec("radius", lo_f, hi_f, bin_count=len(y_ref),
                         xscale="log", yweight="vol", auto_follow=False)
    h = res.histogram([spec]).histograms[0]
    y_eng = h.bins.mean / max(h.bins.mean.sum(), 1e-300)
    bar_err = float(np.max(np.abs(y_eng - y_ref / y_ref.sum())))
    fu = np.where(data.fu == 0, 1.0, data.fu)
    z = float(np.max(np.abs(res.fit_measval_mean
                            - np.asarray(fix["fitMeasValMean"])) / fu))
    if not (bar_err <= 0.2 and z < 3.0):
        raise AssertionError(f"against the reference fixture: max bar "
                             f"diff {bar_err:.3g} (limit 0.2), fit curve "
                             f"{z:.3g} sigma (limit 3)")
    rate = e.total_iters / e.elapsed
    print(f"[fit] 10/10 converged, max chi2 {e.conval.max():.4f}, "
          f"{launches} kernel launches, total_iters {e.total_iters}, "
          f"warm wall {wall:.4f} s (engine {e.elapsed:.4f} s), "
          f"{rate:.4g} proposals/s; warm walls of 5 fits {walls}, median "
          f"{float(np.median(walls)):.4f} s; on {card}", flush=True)
    print(f"[fit] vs reference McSAS: max vol-bar diff {bar_err:.3g} "
          f"(limit 0.2), fit curve within {z:.3g} sigma (limit 3)")
    if profiling:
        profile_fit(torch, lambda: fit(DATA, "Sphere", cfg, device="cuda"),
                    card, "Sphere", "mc_chunk")

    # ---- phase 6: both entries of K2 against their plain versions
    from mcsas_tpu_torch.ops import tables
    from mcsas_tpu_torch.tools import suite
    golden = suite.cylinder_golden()
    cyl_cfg = suite.cylinder_config()
    cyl_bound = suite.cylinder_bound()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, table = cyl_bound.model.ff_table_factory(
        cyl_bound, golden.q, torch.float32, torch.device("cuda"))
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    print(f"[bake] {tuple(table.values.shape)} float32 table, n=801 rule, "
          f"on the card in {bake_s:.3f} s (first torch use of these "
          f"operations included), {card}", flush=True)
    if table.values.shape != (4096, golden.count):
        raise AssertionError(f"table shape {tuple(table.values.shape)}")
    tables_memo = len(tables._TABLE_CACHE)
    k2_windows, k2_errs = [], []
    k2 = {}     # entry -> the kernel line's numbers, without local moves
    for local in (0.0, 0.5):
        ceng = McSASEngine(golden, cyl_bound,
                           cyl_cfg.replace(local_moves=local),
                           device="cuda")
        if len(tables._TABLE_CACHE) != tables_memo:
            raise AssertionError("the engine baked its table again")
        if not (ceng.uses_table and ceng.runs_cuda_kernel
                and ceng.seg_steps == 131):
            raise AssertionError(f"cylinder engine: table {ceng.uses_table}"
                                 f", kernel {ceng.runs_cuda_kernel}, "
                                 f"segment {ceng.seg_steps} (want 131)")
        ceng.gen.manual_seed(1)
        cstate0 = ceng._init_batch()
        cands = mc_kernel.segment_candidates(
            cstate0, 0, ceng.spec, ceng._draw_chunk_proposals(131))
        name = f"K2 local_moves={local}"
        rows, sw, entries, win, errs = check_k2(torch, mc_kernel, name,
                                                ceng, cstate0, cands)
        k2_windows += win
        k2_errs += errs
        cwork = cstate0.clone()
        for entry, (kernel, plain) in entries.items():
            ms = time_chunk(torch, lambda: kernel(cwork.copy_(cstate0), 0,
                                                  131), 10)
            b_ms, b_by = k2_bound(ceng, cstate0, cwork, cands,
                                  rows if entry == "rows" else None, sw)
            plain_ms = time_chunk(torch, lambda: plain(
                cwork.copy_(cstate0), 0, 131), 2)
            shape = mc_kernel.prefetch_launch_shape(
                cstate0, ceng.consts, ceng.spec, cands,
                rows if entry == "rows" else None)
            print(f"[time] {name} {entry} in: 131-step segment at R=10 "
                  f"N=300 K=128 Nq={golden.count} (reset copy included), "
                  f"{card}: kernel {ms:.3f} ms ({ms * 1e3 / 131:.2f} us "
                  f"per step), plain PyTorch {plain_ms:.3f} ms; bound "
                  f"{b_ms:.4f} ms ({b_by}); shape {shape}", flush=True)
            if not local:
                k2[entry] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, shape=shape)
        if profiling and not local:
            # shorter segments split K2's time into a per-launch part
            # (launch, ft rebuild, reset copy) and a per-step part
            for entry, (kernel, _) in entries.items():
                for n in (8, 32):
                    ms = time_chunk(torch, lambda: kernel(
                        cwork.copy_(cstate0), 0, n), 10)
                    print(f"[profile] {name} {entry} in: {n}-step segment "
                          f"{ms:.4f} ms", flush=True)
            # a segment as the fit runs it, outside the draws: sqrt(w) and
            # the table entry, against the row lookup and the rows entry
            # (the pair it replaced)
            draw_ms = time_chunk(
                torch, lambda: ceng._draw_chunk_proposals(131), 10)
            sw_ms = time_chunk(
                torch, lambda: mc_kernel.sqrt_weights(ceng.spec, cands), 10)
            row_ms = time_chunk(torch, lambda: ceng.kern.row(cands), 10)
            print(f"[profile] per 131-step segment, outside K2: draw "
                  f"{draw_ms:.4f} ms, sqrt(w) {sw_ms:.4f} ms (table in), "
                  f"table row lookup {row_ms:.4f} ms (rows in); table in "
                  f"{sw_ms + k2['table']['ms']:.4f} ms against lookup + "
                  f"rows in {row_ms + k2['rows']['ms']:.4f} ms; {card}",
                  flush=True)
        del rows, entries
    ragged_k2, ragged_k2_err = check_k2_ragged(
        torch, mc_kernel, McSASEngine, load, DataConfig, get_model, cyl_cfg,
        card)
    print(f"[ragged] K2, both entries against their plain versions at "
          f"{len(K2_RAGGED)} ragged shapes x 2 proposal modes: max |chi2 "
          f"kernel - plain| {ragged_k2_err!r}", flush=True)
    k2_windows += ragged_k2
    k2_errs.append(ragged_k2_err)

    # ---- phase 7: the cylinder main path
    def cyl_fit():
        return fit(golden, cyl_bound, cyl_cfg, device="cuda")

    def timed_cyl_fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cyl_fit()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cfirst = cyl_fit()
    reset_counts(mc_kernel)
    cres, cwall = timed_cyl_fit()
    k2_launches = mc_kernel.run_prefetch_table_chunk.launches
    k2_rows_launches = mc_kernel.run_prefetch_chunk.launches
    k1_during = mc_kernel.run_chunk.launches
    cwalls = [cwall] + [timed_cyl_fit()[1] for _ in range(4)]
    ce = cres.engine
    for r_ in (cfirst, cres):
        if not (r_.engine.converged.all()
                and r_.engine.conval.max() <= 1.0):
            raise AssertionError(
                f"cylinder path: {int(r_.engine.converged.sum())}/10 "
                f"converged, max chi2 {r_.engine.conval.max()}")
    if k2_launches <= 0 or k2_rows_launches or k1_during:
        raise AssertionError(
            f"cylinder path: {k2_launches} launches of K2's table entry, "
            f"{k2_rows_launches} of its rows entry, {k1_during} of K1")
    # one engine run stages no (S, R, K, Nq) rows: its peak allocation
    # stays below the size of one segment's
    staged_bytes = 131 * 10 * 128 * golden.count * 4
    ceng = McSASEngine(golden, cyl_bound, cyl_cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ceng.run()
    torch.cuda.synchronize()
    run_peak = torch.cuda.max_memory_allocated() - mem0
    if run_peak >= staged_bytes:
        raise AssertionError(f"cylinder path: the engine run allocated "
                             f"{run_peak} B at its peak; a segment's rows "
                             f"are {staged_bytes} B")
    if not (ce.used_table and ce.used_prefetch and ce.used_pallas):
        raise AssertionError("cylinder path: used_table/used_prefetch not "
                             "both set")
    if not np.array_equal(cfirst.engine.contribs, ce.contribs):
        raise AssertionError("cylinder path: two runs of one seed differ")
    if not (ce.contribs.shape == (10, 300, 1)
            and np.isfinite(ce.contribs).all()
            and np.isfinite(cres.fractions.measval).all()
            and cres.fractions.measval.shape == (10, golden.count)):
        raise AssertionError("cylinder path: wrong shape or non-finite "
                             "values")
    mean_r = float(cres.histograms[0].moments.mean[0])
    if not abs(mean_r - GOLDEN_RADIUS) <= 0.1 * GOLDEN_RADIUS:
        raise AssertionError(f"cylinder path: vol-weighted mean radius "
                             f"{mean_r!r} m, golden {GOLDEN_RADIUS} m")
    print(f"[fit cylinder] 10/10 converged, max chi2 {ce.conval.max():.4f},"
          f" {k2_launches} K2 launches (table in), peak allocation of an "
          f"engine run {run_peak} B (a segment's rows: {staged_bytes} B), "
          f"total_iters {ce.total_iters} (the "
          f"JAX package's TPU round: about 4.65M), warm wall {cwall:.4f} s "
          f"(engine {ce.elapsed:.4f} s), "
          f"{ce.total_iters / ce.elapsed:.4g} proposals/s; warm walls of 5"
          f" fits {cwalls}, median {float(np.median(cwalls)):.4f} s; "
          f"vol-weighted mean radius {mean_r * 1e9:.4f} nm (golden 10); "
          f"on {card}", flush=True)
    if profiling:
        profile_fit(torch, cyl_fit, card, "cylinder", "mc_prefetch")
        fit_phases(torch, McSASEngine, histogram_all, golden, cyl_bound,
                   cyl_cfg, card)

    # ---- phase 8: K1 of the elementwise models against its plain version
    from mcsas_tpu_torch.tools.suite import ROWS
    rows_k1 = {name: check_k1_row(torch, mc_kernel, McSASEngine, row,
                                  spills, card)
               for name, row in ROWS.items()}
    ragged_windows, ragged_errs = check_k1_ragged(
        torch, mc_kernel, McSASEngine, load, McSASConfig, DataConfig,
        get_model, spills, card)
    print(f"[ragged] K1 against its plain version at {len(RAGGED)} ragged "
          f"shapes x {len(mc_kernel.K1_MODELS)} models x 2 proposal modes:"
          f" max |chi2 kernel - plain| by model {ragged_errs}", flush=True)

    # ---- phase 9: the suite rows' main paths
    for name, row in ROWS.items():
        rows_k1[name]["launches"] = fit_row(torch, mc_kernel, fit, row, card,
                                            profiling)

    # ---- phase 10: K3, the latency probe
    probe = probe_phase(torch, mc_kernel, card)
    for entry in ("rows", "table"):
        by_lv = {r["level"]: r["us_per_step"] for r in probe["rungs"]
                 if r.get("kernel") == "K2" and r["entry"] == entry}
        print(f"[probe] K2 {entry} in, us per step by rung: "
              + ", ".join(f"{lv}: {by_lv[lv]:.3f}"
                          for lv in mc_kernel.PREFETCH_PROBE_LEVELS)
              + f"; {card}", flush=True)
    for m in mc_kernel.K1_MODELS:
        by_g = {(r["level"], r["group"]): r["us_per_step"]
                for r in probe["rungs"]
                if r["model"] == m.name and not r["k1_shape"]}
        print(f"[probe] {m.name}, us per step by lanes per candidate: ff "
              + ", ".join(f"{g}: {by_g[('ff', g)]:.3f}"
                          for g in mc_kernel.PROBE_GROUPS)
              + "; solve "
              + ", ".join(f"{g}: {by_g[('solve', g)]:.3f}"
                          for g in mc_kernel.PROBE_GROUPS)
              + f"; {card}", flush=True)

    # max_abs_err: the largest |Δχ²| of a kernel's comparisons, over the
    # windows each covers (printed in "compared"); library_ms: no single
    # PyTorch call computes an MC chunk; mc_prefetch: the numbers of its
    # table entry, which the fit runs, its rows entry's under "rows_in"
    # K1's ragged-shape windows are listed with each model's own
    ragged = {m.name: [w for w in ragged_windows
                       if w["mode"].startswith(f"{m.name} ")]
              for m in mc_kernel.K1_MODELS}
    kernels = [{
        "name": "mc_chunk[Sphere]", "route": "cuda",
        "source": "mcsas_tpu_torch/csrc/mc_chunk.cu",
        "replaces": "mcsas_tpu/ops/mc_kernel.py:410", "launches": launches,
        "max_abs_err": max(err_inj, err_phx, ragged_errs["Sphere"]),
        "ms": ms_philox, "plain_ms": ms_plain, "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by, "library_ms": None, "shape": k1_shape,
        "compared": [win_inj, win_phx] + ragged["Sphere"]}]
    for name, row in ROWS.items():
        k = rows_k1[name]
        kernels.append({
            "name": f"mc_chunk[{row.model}]", "route": "cuda",
            "source": "mcsas_tpu_torch/csrc/mc_chunk.cu",
            "replaces": "mcsas_tpu/ops/mc_kernel.py:410",
            "launches": k["launches"],
            "max_abs_err": max(k["max_abs_err"], ragged_errs[row.model]),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "shape": k["shape"],
            "compared": k["compared"] + ragged[row.model]})
    kernels.append({
        "name": "mc_prefetch", "route": "cuda",
        "source": "mcsas_tpu_torch/csrc/mc_prefetch.cu",
        "replaces": "mcsas_tpu/ops/mc_kernel.py:719",
        "launches": k2_launches, "max_abs_err": max(k2_errs),
        "ms": k2["table"]["ms"], "plain_ms": k2["table"]["plain_ms"],
        "bound_ms": k2["table"]["bound_ms"],
        "bound_by": k2["table"]["bound_by"], "library_ms": None,
        "shape": k2["table"]["shape"], "entry": "table in (the fit path)",
        "rows_in": k2["rows"], "compared": k2_windows})
    kernels.append({
        "name": "mc_probe", "route": "cuda",
        "source": "mcsas_tpu_torch/csrc/mc_probe.cu",
        "replaces": "tools/kern_probe.py:124",
        "launches": probe["launches"], "max_abs_err": probe["max_abs_err"],
        "ms": probe["ms"], "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
