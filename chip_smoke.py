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
     full) of both entries and of the table entry with the intensity row,
     one line each;
 11. the smeared cylinder main path: ``fit()`` of the suite row
     'cylinders-smeared' (the slit-smeared cylinder golden, 26 smearing
     offsets; its 4096-row table holds smeared intensities) on
     device="cuda" — the cold wall with the bake, then 10/10 converged,
     max χ² ≤ 1, K2's table entry launched, its rows entry and K1 not,
     two runs of one seed equal, the vol-weighted mean radius within
     10 % of the golden 10 nm; the peak allocation of an engine run and
     of the float64 post pass (the smeared bank in blocks); the warm wall
     time of five fits;
 12. K2's table entry with the intensity row (row = blend·w) against its
     plain version: one 131-step segment of that fit at full width,
     without and with local moves 0.5, and the ragged shapes K2_RAGGED on
     smeared data — every decision identical and every bit of the state
     equal; kernel and plain version timed;
 13. the repaired route: a table that K2's table entry cannot blend (a
     lookup that does not name its parameters; a table of three axes)
     launches the rows-in entry from the engine, one segment bit for bit
     equal to its plain version, and a whole fit through the opaque
     lookup equal to the cylinder fit of phase 7;
 14. the smeared Sphere path, which no kernel runs: ``fit()`` on
     device="cuda" raises under the default config, naming smearing and
     use_pallas='off'; under use_pallas='off' the plain chunk is timed
     (µs per step at the headline shape with 26 smearing offsets) and the
     reference McSAS's own slit-smeared MC run (100 contributions × 5
     repetitions, K=128, local moves 0.5) is fitted and held to its
     fixture;
 15. the table rows' main paths (mcsas_tpu_torch/tools/suite.py,
     TABLE_ROWS: 'ellipsoids-isotropic', one table axis;
     'core-shell-ellipsoid', two; 'kholodenko-worm', two and the
     cross-section of each point): one segment of each engine against
     the plain versions and timed, the cold fit with the bake, then
     ``fit()`` on device="cuda" — 10/10 converged, max χ² ≤ 1, only K2's
     table entry launched, two runs of one seed equal, finite results;
     total_iters, the median warm wall of 5 fits, the post pass's time
     and share, the peak allocations, the vol-weighted means beside the
     generating values (the ellipsoid's a within 10 %);
 16. K2's table entry with the worm's cross-section factor against its
     plain version: a 131-step segment without local moves, the ragged
     shapes WORM_RAGGED (one with the radius fixed) in both proposal
     modes, the raw 495-point data (corner rows read from the table), K3's
     full rung; the smeared worm's segments through the rows-in entry
     (its lookup in blocks of steps) at a small shape and at full width,
     bit for bit, with their peak allocation;
 17. the reference McSAS's joint cylinder run (radius and length active,
     testdata/cylmix.dat) at K=128 with local moves 0.5: with the
     reference's intDiv=100 rule in the loop (the plain chunk), held to
     its fixture as the JAX package's test_crossval_cylinder_local_moves
     holds it; then through K2's table entry at two axes, converged and
     its fit curve held the same way, its bars printed beside the limit;
 18. the ψ-grid cylinders' table rows (mcsas_tpu_torch/tools/suite.py,
     PSI_ROWS: 'cylinders-aspect' and 'cylinders-radial', each on a
     probe-gated table of two axes): ``fit()`` on device="cuda" — the
     cold fit with the probe and the bake, then 10/10 converged, max
     χ² ≤ 1 (the Aspect row, whose one-size golden has sinc zeros its
     table cannot place: χ² descends), only K2's table entry launched,
     two runs of one seed equal, the table's miss at the golden's
     parameters printed, the vol-weighted mean radius (Aspect:
     half-length radius·aspect)
     within 10 % of the golden's; one segment of each engine against the
     plain versions bit for bit and timed; K2 on ψ tables at the ragged
     shapes K2_RAGGED; the radial model with three axes through the
     rows-in entry from the engine, bit for bit; the bake's rows equal
     bit for bit whatever the block size;
 19. the configurations no kernel runs: the ψ tables the interpolation
     probe declines (both models on the wide default ranges) and the
     tilted model raise under use_pallas='auto' on the card, naming the
     reason; under 'off' the plain chunk runs a few steps at the rows'
     shape, descends, and is timed (µs per step);
 20. the 2D (q, ψ) fit 'cylinders-2d' (a 100 × 36 image): 'auto' raises
     naming 2D; ``fit()`` under 'off' at 300 × 10, K=128 and 1024 steps
     an attempt — χ² descends on every repetition, the orientation lands
     within 0.3 rad of ψ₀ (mod π), no kernel launched; the card's float64
     post pass equals the CPU's to 1e-10 relative, timed;
 21. the result files and the command line at the headline config:
     ``run_files`` over a Sphere series (testdata/sasfit_sphere-10-1.dat,
     the same with I and σ scaled × 2 and × 0.5, and a byte copy of the
     first) with series statistics — each fit 10/10 converged, max
     χ² ≤ 1, K1 launched for every file and K2 never, 3 engines built for
     4 files (the copy reuses the cached engine, and its contributions
     equal the first file's bit for bit), every output file present,
     fit.dat equal to the in-memory curve (rtol 1e-6), the series table 4
     rows × the histograms, the HDF5 archive reloaded where h5py imports
     (whether it was written is printed); the cylinder golden written to
     a file through ``run_files`` — 10/10, K2's table entry launched, the
     mean radius within 10 % of 10 nm; ``cli.main`` and
     ``python -m mcsas_tpu_torch`` in a subprocess on the Sphere file —
     exit 0, converged, the files written; the per-file walls (the first
     with the engine's set-up, the cached copy), write_all alone and the
     subprocess's wall;
 22. the sharded ensemble (mcsas_tpu_torch/parallel) on this one card:
     the Sphere headline ``fit(mesh=...)`` on 2 and on 3 repetition
     shards of cuda:0 (5 + 5 and 4 + 3 + 3 repetitions, each shard on its
     own stream) — contributions bitwise equal to phase 5's, K1 launched
     once a chunk per shard (2x and 3x phase 5's launches), 10/10
     converged, the median warm wall of 5 beside phase 5's; the cylinder
     row on 2 shards through K2's table entry — bitwise equal to phase
     7's with twice its launches; the q axis (a 1x2 mesh): under
     use_pallas='auto' it raises naming the q axis, under 'off' 1024
     plain steps descend and agree with the unsharded plain chunk under
     the JAX package's near-tie rule, ms a step of both; a mesh larger
     than the cards raises; ``cli.main(... --mesh 1)`` exits 0 with
     phase 5's K1 launches, a too large --mesh exits 2;
     ``utils.profiling.trace`` of one headline fit writes its trace with
     the annotated span; the native ASCII parser builds with the host
     compiler and parses testdata/*.dat and *.csv byte for byte as the
     Python parser.  No two-card figure exists: the machine has one card.

With ``--profile`` it also runs one more fit of each path under
torch.profiler and prints where the device time went and the device's
idle share, times both entries of K2 on shorter segments, the table
entry against the row lookup followed by the rows entry, and splits
three fits of the cylinder and of each table row into set-up, MC run and
post pass.

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
    """``--profile``: one more warm fit under torch.profiler, through
    ``mcsas_tpu_torch.utils.profiling`` (``trace``, ``annotate``).  Prints
    the device's busy time (the sum of its kernels' self times), the
    chunk kernel's part of it (*kernel*: a name fragment), the idle share
    of the fit's wall time (the fit runs on one stream, so kernels do not
    overlap) and the top kernels."""
    import shutil
    import tempfile
    from mcsas_tpu_torch.utils.profiling import annotate, trace
    tmp = tempfile.mkdtemp(prefix="mcsas_profile_")
    span = f"{label} fit"
    try:
        with trace(tmp) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with annotate(span):
                run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # device-side events only: the profiler also books each kernel's time
    # on the operator that launched it (aten::mul, ...), and summing both
    # would count the eager kernels twice
    on_device = torch.autograd.DeviceType.CUDA
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        # the annotated span is booked on the device's timeline too
        if us > 0 and ev.device_type == on_device and ev.key != span:
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


def fit_phases(torch, engine_cls, histogram_all, data, bound, cfg, card,
               label="cylinder"):
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
        print(f"[profile] {label} fit phases, {card}: set-up "
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
# the worm's cross-section 2 j1(q r)/(q r) per candidate and q point, on its
# cheaper branch (|qr| <= 3: the product, two comparisons, the scaled
# square, the 7-term Horner, the sign, the division, the doubling and the
# multiply into the blend), so that the bound stays a lower one
XS_OPS = 23
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
    ran; table in: the table and the factors *sw* read once, and per
    candidate and q point the blend besides the solve (a multiply-add per
    corner of the table's 2^A, the factor, the clamp and, for an
    amplitude table, the square; the worm's cross-section XS_OPS and the
    grid read once where the lookup has it) — the same work whatever
    implements it."""
    k, nq = eng.spec.k_cand, eng.consts.n
    steps = int((state1.n_iter - state0.n_iter).sum()) // k
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
    rows the engine's lookup gives, 'table' on the table and its factors
    (sqrt(w), or w for an intensity table)."""
    rows = eng.kern.row(cands)
    sw = mc_kernel.table_factors(eng.spec, cands)
    c, sp = eng.consts, eng.spec
    return rows, sw, {
        "rows": (
            lambda st, ri, n, tr=None: mc_kernel.run_prefetch_chunk(
                st, ri, c, sp, rows[:n], cands[:n], trace=tr),
            lambda st, ri, n, tr=None: mc_kernel.prefetch_reference(
                st, ri, c, sp, rows[:n], cands[:n], trace=tr)),
        "table": (
            lambda st, ri, n, tr=None: mc_kernel.run_prefetch_table_chunk(
                st, ri, c, sp, cands[:n], sw._replace(values=sw.values[:n]),
                trace=tr),
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
                    get_model, cyl_cfg, card, smearing=None,
                    model="CylindersIsotropic", tag=None):
    """Both entries of K2 against their plain versions at the K2_RAGGED
    shapes, 64 steps each (with local moves at most N, a segment visiting
    each slot once), without and with local moves: the cylinder model (or
    *model*, a ψ-grid cylinder, with radius and aspect active) on the
    headline data rebinned to the shape's bins, its table baked at that
    grid; with a *smearing* config the data is smeared and the table
    holds intensities.  Returns the compared windows and the largest
    |delta chi2|."""
    windows, worst = [], 0.0
    if tag is None:
        tag = "K2" if smearing is None else "K2 intensity"
    for label, (reps, k, n_bin, n) in K2_RAGGED.items():
        two = label.endswith("2axes")
        bound = get_model(model).bind(
            active=("radius", "aspect") if two else ("radius",),
            active_ranges=dict({"radius": (1e-10, 5e-8)},
                               **({"aspect": (1.0, 30.0)} if two else {})))
        data = load(DATA, config=data_config(n_bin=n_bin,
                                             smearing=smearing))
        for local in (0.0, 0.5):
            eng = engine_cls(data, bound, cyl_cfg.replace(
                num_contribs=n, num_reps=reps, candidates_per_step=k,
                local_moves=local), device="cuda")
            if eng.kern.table_is_intensity != (smearing is not None):
                raise AssertionError(f"[{tag} {label}] table kind")
            eng.gen.manual_seed(5)
            state0 = eng._init_batch()
            steps = min(64, n) if local else 64
            cands = mc_kernel.segment_candidates(
                state0, 0, eng.spec, eng._draw_chunk_proposals(steps))
            rows, _, _, win, errs = check_k2(
                torch, mc_kernel, f"{tag} {label} local_moves={local}", eng,
                state0, cands, need=False)
            windows += win
            worst = max(worst, *errs)
        for r_ in (rows, None):
            shape = mc_kernel.prefetch_launch_shape(
                state0, eng.consts, eng.spec, cands, r_)
            print(f"[shape] {tag} {'rows' if r_ is not None else 'table'} in "
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
    # the table entry with the intensity row, on the smeared cylinder row
    seng = McSASEngine(suite.cylinder_smeared_golden(),
                       suite.cylinder_bound(),
                       suite.cylinder_config(local_moves=0.5), device="cuda")
    seng.gen.manual_seed(4)
    sstate0 = seng._init_batch()
    scands = mc_kernel.segment_candidates(
        sstate0, 0, seng.spec, seng._draw_chunk_proposals(seng.seg_steps))
    factors = mc_kernel.table_factors(seng.spec, scands)
    a, b = sstate0.clone(), sstate0.clone()
    mc_kernel.run_prefetch_table_chunk(a, 0, seng.consts, seng.spec, scands,
                                       factors)
    mc_kernel.run_prefetch_probe(b, 0, seng.consts, seng.spec, "full",
                                 scands, None, factors)
    torch.cuda.synchronize()
    states_equal(torch, "probe, K2 table in, intensity row, full rung", a, b)
    if factors.kind != "w" or not (a.n_moves > 0).all():
        raise AssertionError("[probe] K2 intensity row: factor kind "
                             f"{factors.kind!r}, or nothing accepted")
    print(f"[probe] full rung equal to K2 bit for bit in every state field "
          f"over one {eng.seg_steps}-step segment, both entries and the "
          f"table entry with the intensity row", flush=True)
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


SLIT = dict(do_smear=True, n_steps=25, umbra=0.05e9, penumbra=0.2e9)
# proposals of the JAX package's TPU round on 'cylinders-smeared'
# (BENCHMARKS.md:57): a count
JAX_SMEARED_ITERS = "4,325,376"


def smeared_cylinder_phase(torch, mc_kernel, fit, engine_cls, histogram_all,
                           suite, card, profiling):
    """Phase 11: the suite row 'cylinders-smeared' through the normal
    ``fit()`` on the card.  Returns (its K2 launches, the golden, binding
    and config)."""
    golden = suite.cylinder_smeared_golden()
    bound, cfg = suite.cylinder_bound(), suite.cylinder_config()
    if golden.locs.shape != (golden.count, 26) or golden.count != 100:
        raise AssertionError(f"smeared golden: locs {golden.locs.shape}")

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit(golden, bound, cfg, device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    first, cold = timed()                  # bakes the smeared table
    reset_counts(mc_kernel)
    res, wall = timed()
    table_in = mc_kernel.run_prefetch_table_chunk.launches
    rows_in = mc_kernel.run_prefetch_chunk.launches
    k1 = mc_kernel.run_chunk.launches
    walls = [wall] + [timed()[1] for _ in range(4)]
    e = res.engine
    for r_ in (first, res):
        if not (r_.engine.converged.all()
                and r_.engine.conval.max() <= 1.0):
            raise AssertionError(
                f"smeared cylinder path: {int(r_.engine.converged.sum())}/10"
                f" converged, max chi2 {r_.engine.conval.max()}")
    if table_in <= 0 or rows_in or k1:
        raise AssertionError(
            f"smeared cylinder path: {table_in} launches of K2's table "
            f"entry, {rows_in} of its rows entry, {k1} of K1")
    if not (e.used_table and e.used_prefetch and e.used_pallas):
        raise AssertionError("smeared cylinder path: used_table/"
                             "used_prefetch not both set")
    if not np.array_equal(first.engine.contribs, e.contribs):
        raise AssertionError("smeared cylinder path: two runs of one seed "
                             "differ")
    if not (e.contribs.shape == (10, 300, 1)
            and np.isfinite(e.contribs).all()
            and np.isfinite(res.fractions.measval).all()
            and res.fractions.measval.shape == (10, golden.count)):
        raise AssertionError("smeared cylinder path: wrong shape or "
                             "non-finite values")
    mean_r = float(res.histograms[0].moments.mean[0])
    if not abs(mean_r - GOLDEN_RADIUS) <= 0.1 * GOLDEN_RADIUS:
        raise AssertionError(f"smeared cylinder path: vol-weighted mean "
                             f"radius {mean_r!r} m, golden {GOLDEN_RADIUS}")
    # the fit's fitted curve against the data it fitted: chi2 <= 1 in the
    # float64 post pass too (the exact smeared quadrature, not the table)
    eng = engine_cls(golden, bound, cfg, device="cuda")
    if not (eng.kern.table_is_intensity and eng.prefetch_entry == "table"
            and eng.seg_steps == 131
            and tuple(eng.kern.table.values.shape) == (4096, 100)):
        raise AssertionError("smeared cylinder engine: not the intensity "
                             "table through K2's table entry")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    run = eng.run()
    torch.cuda.synchronize()
    run_peak = torch.cuda.max_memory_allocated() - mem0
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    histogram_all(run.contribs, golden, bound, cfg, None, device=eng.device)
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t0
    post_peak = torch.cuda.max_memory_allocated() - mem0
    whole_bank = 10 * 300 * 100 * 26 * 99 * 8
    # in blocks: the whole pass stays below ONE unblocked temporary of the
    # bank's evaluation (which holds a dozen of them at once)
    if not post_peak < whole_bank:
        raise AssertionError(f"smeared post pass allocated {post_peak} B; "
                             f"one unblocked temporary is {whole_bank} B")
    print(f"[fit cylinders-smeared] 10/10 converged, max chi2 "
          f"{e.conval.max():.4f}, {table_in} K2 launches (table in, "
          f"intensity rows; rows in {rows_in}, K1 {k1}), total_iters "
          f"{e.total_iters} (the JAX package's TPU round: "
          f"{JAX_SMEARED_ITERS}, a count), cold wall with the bake "
          f"{cold:.4f} s, warm wall {wall:.4f} s (engine {e.elapsed:.4f} "
          f"s), {e.total_iters / e.elapsed:.4g} proposals/s; warm walls of "
          f"5 fits {walls}, median {float(np.median(walls)):.4f} s; "
          f"vol-weighted mean radius {mean_r * 1e9:.4f} nm (golden 10); "
          f"peak allocation of an engine run {run_peak} B, of the float64 "
          f"post pass {post_peak} B in {post_s:.4f} s (one unblocked "
          f"temporary of its bank: {whole_bank} B); on {card}", flush=True)
    if profiling:
        profile_fit(torch, lambda: fit(golden, bound, cfg, device="cuda"),
                    card, "cylinders-smeared", "mc_prefetch")
    return table_in, golden, bound, cfg


def intensity_kernel_phase(torch, mc_kernel, engine_cls, load, data_config,
                           get_model, smearing_cls, golden, bound, cfg,
                           card):
    """Phase 12: K2's table entry with the intensity row against its plain
    version at the smeared cylinder fit's full width and at the ragged
    shapes.  Returns the kernel line's numbers."""
    windows, errs, out = [], [], None
    for local in (0.0, 0.5):
        eng = engine_cls(golden, bound, cfg.replace(local_moves=local),
                         device="cuda")
        if not (eng.kern.table_is_intensity and eng.seg_steps == 131):
            raise AssertionError("intensity phase: not the smeared table "
                                 "engine")
        eng.gen.manual_seed(1)
        state0 = eng._init_batch()
        cands = mc_kernel.segment_candidates(
            state0, 0, eng.spec, eng._draw_chunk_proposals(131))
        name = f"K2 intensity local_moves={local}"
        rows, sw, entries, win, err = check_k2(torch, mc_kernel, name, eng,
                                               state0, cands)
        if sw.kind != "w":
            raise AssertionError(f"[{name}] factor kind {sw.kind!r}")
        windows += win
        errs += err
        work = state0.clone()
        kernel, plain = entries["table"]
        ms = time_chunk(torch, lambda: kernel(work.copy_(state0), 0, 131),
                        10)
        b_ms, b_by = k2_bound(eng, state0, work, cands, None, sw)
        plain_ms = time_chunk(torch, lambda: plain(work.copy_(state0), 0,
                                                   131), 2)
        f_ms = time_chunk(
            torch, lambda: mc_kernel.table_factors(eng.spec, cands), 10)
        shape = mc_kernel.prefetch_launch_shape(state0, eng.consts,
                                                eng.spec, cands)
        print(f"[time] {name} table in: 131-step segment at R=10 N=300 "
              f"K=128 Nq={golden.count} (reset copy included), {card}: "
              f"kernel {ms:.3f} ms ({ms * 1e3 / 131:.2f} us per step), "
              f"plain PyTorch {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_by}); the factors w outside the kernel {f_ms:.4f} ms; "
              f"shape {shape}", flush=True)
        if not local:
            out = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, shape=shape)
        del rows, entries
    ragged, ragged_err = check_k2_ragged(
        torch, mc_kernel, engine_cls, load, data_config, get_model, cfg,
        card, smearing=smearing_cls(**dict(SLIT, n_steps=4)))
    print(f"[ragged] K2 with the intensity row, both entries against their "
          f"plain versions at {len(K2_RAGGED)} ragged shapes x 2 proposal "
          f"modes: max |chi2 kernel - plain| {ragged_err!r}", flush=True)
    out.update(max_abs_err=max(errs + [ragged_err]),
               compared=windows + ragged)
    return out


def route_phase(torch, mc_kernel, fit, engine_cls, suite, cyl_contribs, card):
    """Phase 13: tables that K2's table entry cannot blend run through its
    rows-in entry from the engine."""
    golden, cfg = suite.cylinder_golden(), suite.cylinder_config()
    for kind in ("opaque-lookup", "three-axes"):
        bound = suite.unblendable_cylinder(kind)
        eng = engine_cls(golden, bound, cfg, device="cuda")
        refusal = mc_kernel.table_blend_refusal(eng.kern)
        if not (eng.uses_table and eng.runs_cuda_kernel
                and eng.prefetch_entry == "rows" and refusal):
            raise AssertionError(f"[route {kind}] entry "
                                 f"{eng.prefetch_entry!r}, refusal "
                                 f"{refusal!r}")
        eng.gen.manual_seed(1)
        state0 = eng._init_batch()
        gen_state = eng.gen.get_state()
        cands = mc_kernel.segment_candidates(
            state0, 0, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
        ts = state0.clone()
        mc_kernel.prefetch_table_reference(ts, 0, eng.consts, eng.spec,
                                           cands)
        eng.gen.set_state(gen_state)
        reset_counts(mc_kernel)
        ks, _ = eng._segment(state0.clone(), 0)
        torch.cuda.synchronize()
        counts = (mc_kernel.run_prefetch_chunk.launches,
                  mc_kernel.run_prefetch_table_chunk.launches)
        if counts != (1, 0):
            raise AssertionError(f"[route {kind}] launches (rows in, table "
                                 f"in) {counts}, want (1, 0)")
        states_equal(torch, f"route {kind}", ks, ts)
        if not (ks.n_moves > 0).all():
            raise AssertionError(f"[route {kind}] accepted nothing")
        print(f"[route {kind}] table of {tuple(eng.kern.table.values.shape)}"
              f", {len(eng.kern.table.axes)} axes ({refusal}): the engine's "
              f"{eng.seg_steps}-step segment launched K2's rows-in entry "
              f"once, its table entry never, and equals the plain version "
              f"bit for bit", flush=True)
    # a whole fit through the opaque lookup: the cylinder fit's rows, so
    # the cylinder fit's result (both entries equal the plain version)
    reset_counts(mc_kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(golden, suite.unblendable_cylinder("opaque-lookup"), cfg,
              device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows_in = mc_kernel.run_prefetch_chunk.launches
    if (rows_in <= 0 or mc_kernel.run_prefetch_table_chunk.launches
            or mc_kernel.run_chunk.launches):
        raise AssertionError(f"[route fit] {rows_in} rows-in launches")
    if not np.array_equal(res.engine.contribs, cyl_contribs):
        raise AssertionError("[route fit] the fit through the rows-in entry "
                             "differs from the fit through the table entry")
    print(f"[route fit] cylinder fit through K2's rows-in entry: "
          f"{rows_in} launches, 10/10 converged "
          f"{bool(res.engine.converged.all())}, equal to the fit through "
          f"the table entry in every contribution; wall {wall:.4f} s on "
          f"{card}", flush=True)
    return rows_in


def smeared_sphere_phase(torch, mc_kernel, fit, engine_cls, load,
                         data_config, smearing_cls, get_model, cfg, suite,
                         card):
    """Phase 14: the smeared Sphere path (no kernel): the default config
    raises on the card; the plain chunk timed; the reference's smeared MC
    run fitted with the plain chunk and held to its fixture."""
    data = load(DATA, config=data_config(smearing=smearing_cls(**SLIT)))
    try:
        fit(data, "Sphere", cfg, device="cuda")
    except ValueError as exc:
        text = str(exc)
        if "smeared" not in text or "use_pallas='off'" not in text:
            raise AssertionError(f"smeared Sphere: error text {text!r}")
        print(f"[smeared sphere] fit(device='cuda') under the default "
              f"config raises: {text}", flush=True)
    else:
        raise AssertionError("smeared Sphere fit on the card did not raise "
                             "under use_pallas='auto'")
    off = cfg.replace(use_pallas="off")
    eng = engine_cls(data, get_model("Sphere").bind(), off, device="cuda")
    if eng.runs_cuda_kernel or eng.kern.locs.shape != (data.count, 26):
        raise AssertionError("smeared Sphere: not the plain chunk on 26 "
                             "offsets")
    eng.gen.manual_seed(1)
    state0 = eng._init_batch()
    work = state0.clone()
    steps = 200
    props = eng._draw_chunk_proposals(n_steps=steps)
    reset_counts(mc_kernel)
    ms = time_chunk(torch, lambda: mc_kernel.chunk_reference(
        work.copy_(state0), 0, eng.consts, eng.spec, props), 2)
    print(f"[smeared sphere] plain chunk, {steps} steps at R=10 N=300 K=128 "
          f"Nq={data.count} with 26 smearing offsets (local moves 0.5), "
          f"{card}: {ms:.2f} ms, {ms * 1e3 / steps:.1f} us per step (K1 "
          f"unsmeared at this shape: see mc_chunk[Sphere])", flush=True)
    fix, d, bound, mcfg = suite.smearmc_workload(
        candidates_per_step=128, local_moves=0.5, chunk_steps=250,
        use_pallas="off")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(d, bound, mcfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if mc_kernel.run_chunk.launches or res.engine.used_pallas:
        raise AssertionError("smeared Sphere: a kernel was launched under "
                             "use_pallas='off'")
    got = suite.check_smearmc(fix, d, bound, mcfg, res.engine,
                              weights=("vol",), check_moments=False,
                              device="cuda")
    e = res.engine
    # the repetitions step together until the last has converged: without
    # a retry the engine ran the longest repetition's steps, in whole chunks
    per_step = "a retry ran: steps not counted"
    if e.total_iters == int(e.n_iter.sum()):
        ran = -(-int(e.n_iter.max()) // (128 * 250)) * 250
        per_step = (f"{ran} steps of all 5 repetitions, "
                    f"{e.elapsed * 1e6 / ran:.1f} us per step")
    print(f"[smeared sphere] the reference McSAS's slit-smeared MC run "
          f"(100 x 5, K=128, local moves 0.5, Nq={d.count}, 26 offsets) "
          f"with the plain chunk on the card: 5/5 converged, max chi2 "
          f"{e.conval.max():.4f}, total_iters {e.total_iters}, wall "
          f"{wall:.3f} s (engine {e.elapsed:.3f} s, {per_step}); against "
          f"the reference's fixture: {got}; on {card}", flush=True)
    return ms * 1e3 / steps


# total_iters of the JAX package's TPU round on the table rows
# (BENCHMARKS.md:51-61): counts
JAX_TABLE_ITERS = {"ellipsoids-isotropic": 3_599_616,
                   "core-shell-ellipsoid": 2_229_504,
                   "kholodenko-worm": 1_944_704}
# the generating values a table row's vol-weighted mean is held to (10 %):
# the worm's (1, 10, 1000 nm) sit on the edges of its default ranges and
# the core-shell ellipsoid's fit trades a against t, so only the
# ellipsoid's a is gated; the others are printed beside their truth
GATED = {"ellipsoids-isotropic": ("a",)}


def k2_segment(torch, mc_kernel, name, eng, card, seed=1, timed=True,
               need=True):
    """One segment of the engine at its own shape (the fit's segment):
    both entries of K2 against their plain versions (check_k2; with
    *need* every repetition must accept), then the table entry, the plain
    version and the factors outside the kernel timed with CUDA events.
    Returns the windows, the largest |delta chi2| and the kernel line's
    numbers (None without *timed*)."""
    eng.gen.manual_seed(seed)
    state0 = eng._init_batch()
    steps = eng.seg_steps
    cands = mc_kernel.segment_candidates(
        state0, 0, eng.spec, eng._draw_chunk_proposals(steps))
    rows, sw, entries, win, errs = check_k2(torch, mc_kernel, name, eng,
                                            state0, cands, need)
    out = None
    if timed:
        work = state0.clone()
        kernel, plain = entries["table"]
        ms = time_chunk(torch, lambda: kernel(work.copy_(state0), 0, steps),
                        10)
        b_ms, b_by = k2_bound(eng, state0, work, cands, None, sw)
        plain_ms = time_chunk(torch, lambda: plain(work.copy_(state0), 0,
                                                   steps), 2)
        f_ms = time_chunk(
            torch, lambda: mc_kernel.table_factors(eng.spec, cands), 10)
        shape = mc_kernel.prefetch_launch_shape(state0, eng.consts,
                                                eng.spec, cands)
        print(f"[time] {name} table in: {steps}-step segment at R="
              f"{eng.cfg.num_reps} N={eng.cfg.num_contribs} K="
              f"{eng.spec.k_cand} Nq={eng.consts.n}, "
              f"{len(eng.spec.table_layout)} table axes, factor "
              f"{eng.spec.factor_layout} (reset copy included), {card}: "
              f"kernel {ms:.3f} ms ({ms * 1e3 / steps:.2f} us per step), "
              f"plain PyTorch {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_by}); the factors sqrt(w) outside the kernel "
              f"{f_ms:.4f} ms; shape {shape}", flush=True)
        out = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   shape=shape, steps=steps)
    del rows, entries
    return win, max(errs), out


def table_rows_phase(torch, mc_kernel, fit, engine_cls, histogram_all,
                     suite, card, profiling):
    """Phase 15: the table rows of the suite (suite.TABLE_ROWS) through
    the normal ``fit()`` on the card.  For each: one segment of its
    engine against the plain versions and timed (k2_segment); the cold
    fit with the bake; five warm fits, the launch counts over the first
    (K2's table entry only); 10/10 converged, max chi2 <= 1, two runs of
    one seed equal, finite values of the expected shape; the post pass
    timed apart, the peak allocation of a fit; the vol-weighted means
    beside the generating values (GATED within 10 %).  Returns {row:
    numbers}."""
    out = {}
    for name, row in suite.TABLE_ROWS.items():
        data = row.load()
        bound = row.bound(data)
        cfg = row.config()

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r_ = fit(data, bound, cfg, device="cuda")
            torch.cuda.synchronize()
            return r_, time.perf_counter() - t0

        first, cold = timed()               # bakes the row's table
        reset_counts(mc_kernel)
        res, wall = timed()
        table_in = mc_kernel.run_prefetch_table_chunk.launches
        rows_in = mc_kernel.run_prefetch_chunk.launches
        k1 = mc_kernel.run_chunk.launches
        walls = [wall] + [timed()[1] for _ in range(4)]
        e = res.engine
        for r_ in (first, res):
            if not (r_.engine.converged.all()
                    and r_.engine.conval.max() <= 1.0):
                raise AssertionError(
                    f"[fit {name}] {int(r_.engine.converged.sum())}/10 "
                    f"converged, max chi2 {r_.engine.conval.max()}")
        if table_in <= 0 or rows_in or k1:
            raise AssertionError(
                f"[fit {name}] {table_in} launches of K2's table entry, "
                f"{rows_in} of its rows entry, {k1} of K1")
        if not (e.used_table and e.used_prefetch and e.used_pallas):
            raise AssertionError(f"[fit {name}] used_table/used_prefetch "
                                 "not both set")
        if not np.array_equal(first.engine.contribs, e.contribs):
            raise AssertionError(f"[fit {name}] two runs of one seed "
                                 "differ")
        p = bound.n_active
        if not (e.contribs.shape == (10, 300, p)
                and np.isfinite(e.contribs).all()
                and np.isfinite(res.fractions.measval).all()
                and res.fractions.measval.shape == (10, data.count)):
            raise AssertionError(f"[fit {name}] wrong shape or non-finite "
                                 "values")
        eng = engine_cls(data, bound, cfg, device="cuda")
        worm = row.model == "Kholodenko"
        n_axes = len(eng.spec.table_layout)
        if not (eng.prefetch_entry == "table"
                and (eng.spec.factor_layout[0] == 1) == worm
                and n_axes == (1 if name == "ellipsoids-isotropic" else 2)):
            raise AssertionError(f"[fit {name}] entry {eng.prefetch_entry}"
                                 f", {n_axes} axes, factor "
                                 f"{eng.spec.factor_layout}")
        win, err, seg = k2_segment(torch, mc_kernel, f"K2 {name}", eng,
                                   card)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        run = eng.run()
        torch.cuda.synchronize()
        run_peak = torch.cuda.max_memory_allocated() - mem0
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        histogram_all(run.contribs, data, bound, cfg, None,
                      device=eng.device)
        torch.cuda.synchronize()
        post_s = time.perf_counter() - t0
        post_peak = torch.cuda.max_memory_allocated() - mem0
        median = float(np.median(walls))
        means = {h.spec.param: float(h.moments.mean[0])
                 for h in res.histograms if h.spec.yweight == "vol"}
        if set(means) != set(bound.active) or not all(
                np.isfinite(v) for v in means.values()):
            raise AssertionError(f"[fit {name}] vol-weighted means {means}")
        for pname in GATED.get(name, ()):
            want = row.truth[pname]
            if not abs(means[pname] - want) <= 0.1 * want:
                raise AssertionError(f"[fit {name}] vol-weighted mean "
                                     f"{pname} {means[pname]!r}, "
                                     f"generating value {want!r}")
        print(f"[fit {name}] 10/10 converged, max chi2 "
              f"{e.conval.max():.4f}, {table_in} K2 launches (table in, "
              f"{n_axes} axes{', cross-section factor' if worm else ''}; "
              f"rows in {rows_in}, K1 {k1}), total_iters {e.total_iters} "
              f"(the JAX package's TPU round: {JAX_TABLE_ITERS[name]:,}, a "
              f"count), cold wall with the bake {cold:.4f} s, warm walls "
              f"of 5 fits {walls}, median {median:.4f} s (engine "
              f"{e.elapsed:.4f} s, {e.total_iters / e.elapsed:.4g} "
              f"proposals/s); post pass and histograms {post_s:.4f} s "
              f"({post_s / median:.1%} of the median wall), peak "
              f"allocation of an engine run {run_peak} B, of the post pass "
              f"{post_peak} B; vol-weighted means {means} (generating "
              f"values {row.truth}; gated within 10 %: "
              f"{GATED.get(name, ())}); on {card}", flush=True)
        if profiling:
            profile_fit(torch, lambda: fit(data, bound, cfg, device="cuda"),
                        card, name, "mc_prefetch")
            fit_phases(torch, engine_cls, histogram_all, data, bound, cfg,
                       card, name)
        out[name] = dict(seg, launches=table_in, max_abs_err=err,
                         compared=win, median=median)
    return out


# K2_RAGGED for the worm: every shape on the worm's own two axes with its
# radius active, and one with the radius fixed (the factor's parameter a
# fixed value)
WORM_RAGGED = dict(RAGGED, **{"r3-k48-bins100-radius-fixed":
                              (3, 48, 100, 64)})


def factor_kernel_phase(torch, mc_kernel, engine_cls, load, data_config,
                        smearing_cls, get_model, suite, card):
    """Phase 16: K2's table entry with the worm's cross-section factor
    against its plain version: one 131-step segment of the worm row
    without local moves (the row's own 0.75 is phase 15's), the ragged
    shapes WORM_RAGGED in both proposal modes, a segment on the raw
    500-point data (Nq > 104: the corner rows read from the table), K3's
    full rung; then the smeared worm, whose rows go through the rows-in
    entry in blocks of steps: one segment at a small shape and one at full
    width, each bit for bit its plain version, with the peak allocation.
    Returns the kernel line's windows and largest |delta chi2|."""
    row = suite.TABLE_ROWS["kholodenko-worm"]
    kho = os.path.join(HERE, "testdata", row.data)
    data = row.load()
    eng = engine_cls(data, row.bound(data), row.config(local_moves=0.0),
                     device="cuda")
    windows, err, _ = k2_segment(torch, mc_kernel, "K2 factor local_moves=0",
                                 eng, card, timed=False)
    errs = [err]
    for label, (reps, k, n_bin, n) in WORM_RAGGED.items():
        d = load(kho, config=data_config(n_bin=n_bin))
        fixed_r = label.endswith("radius-fixed")
        bound = (get_model("Kholodenko").bind(
            active=("lenKuhn", "lenContour"), fixed={"radius": 2e-9})
            if fixed_r else row.bound(d))
        for local in (0.0, 0.5):
            e_ = engine_cls(d, bound, row.config(
                num_contribs=n, num_reps=reps, candidates_per_step=k,
                local_moves=local, chunk_steps=64), device="cuda")
            want = (1, -1, 2e-9) if fixed_r else (1, 0, 0.0)
            if e_.spec.factor_layout != want:
                raise AssertionError(f"[K2 factor {label}] factor "
                                     f"{e_.spec.factor_layout}, want {want}")
            win, e2, _ = k2_segment(torch, mc_kernel,
                                    f"K2 factor {label} local_moves={local}",
                                    e_, card, seed=5, timed=False,
                                    need=False)
            windows += win
            errs.append(e2)
        shape = mc_kernel.prefetch_launch_shape(
            *_segment_shape_args(mc_kernel, e_))
        print(f"[shape] K2 factor table in at {label} (K={k} "
              f"Nq={e_.consts.n}): {shape}; {card}", flush=True)
    # Nq = 495 > 104 points: the corner rows come from the table (L2)
    raw = load(kho, config=data_config(n_bin=0))
    e_ = engine_cls(raw, row.bound(raw), row.config(), device="cuda")
    shape = mc_kernel.prefetch_launch_shape(
        *_segment_shape_args(mc_kernel, e_))
    if shape["source"] != "table":
        raise AssertionError(f"[K2 factor raw] source {shape['source']}")
    win, e2, raw_t = k2_segment(torch, mc_kernel, "K2 factor raw data", e_,
                                card)
    windows += win
    errs.append(e2)
    # K3's full rung with the factor, bit for bit K2
    eng.gen.manual_seed(4)
    state0 = eng._init_batch()
    cands = mc_kernel.segment_candidates(
        state0, 0, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    factors = mc_kernel.table_factors(eng.spec, cands)
    a, b = state0.clone(), state0.clone()
    mc_kernel.run_prefetch_table_chunk(a, 0, eng.consts, eng.spec, cands,
                                       factors)
    mc_kernel.run_prefetch_probe(b, 0, eng.consts, eng.spec, "full", cands,
                                 None, factors)
    torch.cuda.synchronize()
    states_equal(torch, "probe, K2 table in with the factor, full rung",
                 a, b)
    print(f"[probe] full rung equal to K2's table entry with the "
          f"cross-section bit for bit over one {eng.seg_steps}-step "
          f"segment", flush=True)
    # the smeared worm: rows in, its lookup in blocks of steps
    for label, reps, k, n in (("small", 2, 16, 64), ("full", 10, 128, 300)):
        sd = load(kho, config=data_config(smearing=smearing_cls(**SLIT)))
        se = engine_cls(sd, row.bound(sd), row.config(
            num_contribs=n, num_reps=reps, candidates_per_step=k),
            device="cuda")
        if not (se.prefetch_entry == "rows" and se.kern.table_is_intensity
                and se.kern.table.values.shape[1] == sd.count * 26):
            raise AssertionError(f"[smeared worm {label}] entry "
                                 f"{se.prefetch_entry}, table "
                                 f"{tuple(se.kern.table.values.shape)}")
        se.gen.manual_seed(1)
        sstate0 = se._init_batch()
        gen_state = se.gen.get_state()
        scands = mc_kernel.segment_candidates(
            sstate0, 0, se.spec, se._draw_chunk_proposals(se.seg_steps))
        ts = sstate0.clone()
        mc_kernel.prefetch_table_reference(ts, 0, se.consts, se.spec,
                                           scands)
        se.gen.set_state(gen_state)
        ks = sstate0.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        reset_counts(mc_kernel)
        t0 = time.perf_counter()
        se._segment(ks, 0)
        torch.cuda.synchronize()
        seg_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        counts = (mc_kernel.run_prefetch_chunk.launches,
                  mc_kernel.run_prefetch_table_chunk.launches)
        if counts != (1, 0):
            raise AssertionError(f"[smeared worm {label}] launches (rows "
                                 f"in, table in) {counts}")
        states_equal(torch, f"smeared worm {label}", ks, ts)
        block = max(1, mc_kernel.ROWS_BLOCK_VALUES
                    // (k * se.kern.table.values.shape[1]))
        print(f"[smeared worm {label}] R={reps} N={n} K={k} Nq={sd.count} x "
              f"26 offsets, table {tuple(se.kern.table.values.shape)}: one "
              f"{se.seg_steps}-step segment through K2's rows-in entry "
              f"(lookup in blocks of {block} steps of one repetition) "
              f"equals its plain version bit for bit; {seg_s * 1e3:.2f} ms "
              f"with the lookup, "
              f"peak allocation {peak} B (PREFETCH_ROW_BYTES "
              f"{mc_kernel.PREFETCH_ROW_BYTES} B; the segment's rows "
              f"{scands[..., 0].numel() * sd.count * 4} B); {card}",
              flush=True)
    return windows, max(errs), raw_t


def _segment_shape_args(mc_kernel, eng):
    """(state, consts, spec, cands) of one fresh segment of *eng*, for
    prefetch_launch_shape."""
    eng.gen.manual_seed(2)
    state = eng._init_batch()
    cands = mc_kernel.segment_candidates(
        state, 0, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
    return state, eng.consts, eng.spec, cands


def cylinder_crossval_phase(torch, mc_kernel, fit, suite, card):
    """Phase 17: the reference McSAS's joint cylinder run (radius and
    length active, 100 x 5) fitted on the card at K=128 with local moves
    0.5, twice.  First as the JAX package's
    test_crossval_cylinder_local_moves runs it: the reference's own
    intDiv=100 rule in the loop (table_ff 'off', so the plain chunk under
    use_pallas 'off'), held to that test's tolerances (vol-weighted bars
    of both parameters within 0.2 of the reference's, the fit curve
    within 3 sigma and below 1 sigma^2 on average).  Then through the fit
    path, the two-axis cylinder table in K2's table entry: converged and
    the fit curve held the same way; its bars are printed beside the 0.2,
    not held to it, since the table carries the converged n=801 rule,
    which departs from the reference's intDiv=100 rule by up to 2.7x at
    the box corners (the JAX test's reason for table_ff 'off').  Returns
    the K2 launches of the second run."""
    out = {}
    for label, variant in (
            ("the reference's intDiv=100 rule, the plain chunk",
             dict(table_ff="off", use_pallas="off")),
            ("the 2-axis table through K2's table entry", {})):
        fix, d, bound, cfg = suite.cylinder_crossval_workload(
            candidates_per_step=128, local_moves=0.5, **variant)
        reset_counts(mc_kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(d, bound, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        e = res.engine
        counts = (mc_kernel.run_prefetch_table_chunk.launches,
                  mc_kernel.run_prefetch_chunk.launches,
                  mc_kernel.run_chunk.launches)
        exact = bool(variant)
        if (counts != (0, 0, 0) if exact else
                (counts[0] <= 0 or counts[1:] != (0, 0))):
            raise AssertionError(f"[crossval cylinder, {label}] launches "
                                 f"(table in, rows in, K1) {counts}")
        if exact == bool(e.used_table):
            raise AssertionError(f"[crossval cylinder, {label}] used_table "
                                 f"{e.used_table}")
        got = suite.check_smearmc(
            fix, d, bound, cfg, e, weights=("vol",), check_moments=False,
            device="cuda", params=("radius", "length"),
            bar_limit=0.2 if exact else None)
        held = "held to 0.2" if exact else "printed, not held"
        print(f"[crossval cylinder] the reference McSAS's joint cylinder "
              f"run (radius and length, 100 x 5, chi2 <= "
              f"{cfg.convergence_criterion}) at K=128, local moves 0.5, "
              f"{label}: 5/5 converged, max chi2 {e.conval.max():.4f}, "
              f"launches (table in, rows in, K1) {counts}, total_iters "
              f"{e.total_iters}, wall {wall:.3f} s; against the "
              f"reference's fixture (bars {held}): {got}; on {card}",
              flush=True)
        out[exact] = counts[0]
    return out[False]


# ------------------------------------------------ the ψ-grid cylinders

# what each ψ table row's vol-weighted mean is held to (10 % of the
# golden's): the radial row's radius; the Aspect model's ψ grid spans
# 0-π DEGREES read as radians (sin ψ ≤ 0.055), so its rows hardly see the
# radius and fix only the half-length radius·aspect (its fits end near
# radius 10 nm, aspect 1 against the golden's 5 nm and 2): that product
# is held there, the radius printed beside it
PSI_GATED = {"cylinders-aspect": ("half_length", 5e-9 * 2.0),
             "cylinders-radial": ("radius", 10e-9)}
# the parameters of the ψ rows' goldens (suite.cylinder_aspect_golden,
# suite.cylinder_radial_golden)
PSI_GOLDEN = {"cylinders-aspect": {"radius": 5e-9, "aspect": 2.0},
              "cylinders-radial": {"radius": 10e-9, "psiAngle": 0.17}}
# the ψ rows held to chi2 <= 1 on every repetition.  'cylinders-aspect'
# is not: its golden (one size, 1 % uncertainty) has the deep sinc zeros
# of an aligned rod, which the 512 x 64 table cannot place (the phase
# prints the blend's miss at the golden's parameters, psi_golden_misfit),
# so its fit stalls well above chi2 = 1 within any budget: the phase
# holds it to descent and runs it for its bounded budget
PSI_CONVERGES = ("cylinders-radial",)


class table_env:
    """MCSAS_TPU_TABLE_RES_CAP=*cap* and the interpolation probe bypassed
    for the block: small tables for the route and ragged-shape checks,
    which hold K2 to its plain version on whatever table it reads."""

    def __init__(self, cap):
        self.set = {"MCSAS_TPU_TABLE_RES_CAP": str(cap),
                    "MCSAS_TPU_TABLE_PROBE": "off"}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.set}
        os.environ.update(self.set)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def vol_mean(res, values):
    """The volume-weighted mean of *values* (R, N) over each repetition's
    contributions (res.fractions.fraction['vol'] is (N, R)), averaged
    over the repetitions: the histograms' vol-weighted mean of any
    function of the parameters."""
    f = res.fractions.fraction["vol"].T
    return float(np.mean((f * values).sum(axis=1) / f.sum(axis=1)))


def psi_bake_blocks(torch, cylinders, tables, card):
    """The ψ bake's rows on the card at several block sizes, bit for bit:
    44 rows of the radial model's converged rule on 100, 101 and 30 q
    points in blocks of 4, 8, 12, the factory's own size and one block of
    all (the factory's blocks are whole multiples of 4 rows:
    cylinders._psi_bake_block)."""
    for nq in (100, 101, 30):
        q32 = torch.tensor(np.geomspace(1e7, 1e9, nq), dtype=torch.float32,
                           device="cuda")

        def row_fn(vals):
            return cylinders._cyl_radial_ff(q32, dict(
                radius=vals[:, 0:1], psiAngle=vals[:, 1:2], aspect=10.0,
                psiAngleDivisions=3001.0))

        grids = [tables.log_grid(1e-9, 3e-8, 11),
                 tables.log_grid(0.01, 6.29, 4)]
        blocks = (44, 4, 8, 12, cylinders._psi_bake_block(nq, 3001))
        outs = [tables.build_param_table(row_fn, grids, block=b,
                                         device="cuda").values
                for b in blocks]
        for b, o in zip(blocks[1:], outs[1:]):
            if not torch.equal(o, outs[0]):
                raise AssertionError(f"[psi bake] Nq={nq}: rows in blocks "
                                     f"of {b} differ from one block")
        # blocks that are no multiple of 4 rows: printed, not held
        odd = {}
        for b in (1, 3, 5, 7):
            o = tables.build_param_table(row_fn, grids, block=b,
                                         device="cuda").values
            odd[b] = float(((o - outs[0]).abs()
                            / outs[0].abs().clamp_min(1e-30)).max())
        print(f"[psi bake] Nq={nq}: blocks of 1, 3, 5, 7 rows against one "
              f"block, max relative difference {odd}", flush=True)
    print(f"[psi bake] 44 rows of the 3001-node radial rule on 100, 101 and "
          f"30 q points, in blocks of 4, 8, 12 and the factory's "
          f"{cylinders._psi_bake_block(100, 3001)} (at 100 points): bit for "
          f"bit one block's; {card}", flush=True)


def psi_golden_misfit(torch, eng, data, golden):
    """The table's blend at the golden's parameters against the exact
    converged rule there, in float64 on the fit grid: (max, rms) of the
    probe's metric |Δff²| / (ff² + 1e-6·max ff²) — how closely the table
    tier can represent the golden at all."""
    bound, kern = eng.bound, eng.kern
    pv = torch.tensor([[golden[n] for n in bound.active]],
                      dtype=torch.float32, device="cuda")
    blend = kern.table_fn(kern.table, bound.pdict(pv))[0].double()
    p = dict(bound.fixed, psiAngleDivisions=3001.0)
    p.update({n: float(golden[n]) for n in bound.active})
    exact = bound.model.ff(torch.tensor(data.q, dtype=torch.float64,
                                        device="cuda"), p)
    e2, a2 = exact ** 2, blend ** 2
    err = (a2 - e2).abs() / (e2 + 1e-6 * e2.max())
    return float(err.max()), float(err.pow(2).mean().sqrt())


def psi_table_rows_phase(torch, mc_kernel, fit, engine_cls, histogram_all,
                         load, data_config, get_model, suite, card,
                         profiling):
    """Phase 18: the ψ-grid cylinders' table rows (suite.PSI_ROWS
    'cylinders-aspect', 'cylinders-radial') through ``fit()`` on the
    card: the cold fit with the probe and the bake, five warm fits, the
    launch counts over the first (K2's table entry only, 2 axes); 10/10
    converged with max chi2 <= 1 (PSI_CONVERGES; the Aspect row: chi2
    descends on every repetition), two runs of one seed equal, finite
    values of the expected shape, the vol-weighted mean of PSI_GATED
    within 10 %;
    one segment of each engine against the plain versions, bit for bit,
    and timed (k2_segment).  Then K2 on ψ tables at the ragged shapes
    (32 nodes an axis, probe bypassed), the radial model with three axes
    through the rows-in entry from the engine, bit for bit, and the bake's
    block invariance.  Returns {row: numbers}."""
    from mcsas_tpu_torch.models import cylinders
    from mcsas_tpu_torch.ops import tables
    out = {}
    for name in ("cylinders-aspect", "cylinders-radial"):
        row = suite.PSI_ROWS[name]
        data = row.load()
        bound = row.bound(data)
        cfg = row.config()

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r_ = fit(data, bound, cfg, device="cuda")
            torch.cuda.synchronize()
            return r_, time.perf_counter() - t0

        first, cold = timed()               # probes and bakes the table
        reset_counts(mc_kernel)
        res, wall = timed()
        counts = (mc_kernel.run_prefetch_table_chunk.launches,
                  mc_kernel.run_prefetch_chunk.launches,
                  mc_kernel.run_chunk.launches)
        walls = [wall] + [timed()[1] for _ in range(4)]
        e = res.engine
        eng = engine_cls(data, bound, cfg, device="cuda")
        eng.gen.manual_seed(cfg.seed)
        chi0 = eng._init_batch().conval.double().cpu().numpy()
        for r_ in (first, res):
            if name in PSI_CONVERGES:
                ok = (r_.engine.converged.all()
                      and r_.engine.conval.max() <= 1.0)
            else:
                ok = (r_.engine.conval < chi0).all()
            if not ok:
                raise AssertionError(
                    f"[fit {name}] {int(r_.engine.converged.sum())}/10 "
                    f"converged, chi2 {r_.engine.conval} from {chi0}")
        if counts[0] <= 0 or counts[1:] != (0, 0):
            raise AssertionError(f"[fit {name}] launches (table in, rows "
                                 f"in, K1) {counts}")
        if not (e.used_table and e.used_prefetch and e.used_pallas):
            raise AssertionError(f"[fit {name}] used_table/used_prefetch "
                                 "not both set")
        if not np.array_equal(first.engine.contribs, e.contribs):
            raise AssertionError(f"[fit {name}] two runs of one seed "
                                 "differ")
        if not (e.contribs.shape == (10, 300, 2)
                and np.isfinite(e.contribs).all()
                and np.isfinite(res.fractions.measval).all()
                and res.fractions.measval.shape == (10, data.count)):
            raise AssertionError(f"[fit {name}] wrong shape or non-finite "
                                 "values")
        if not (eng.prefetch_entry == "table"
                and len(eng.spec.table_layout) == 2
                and eng.spec.factor_layout == (0, -1, 0.0)):
            raise AssertionError(f"[fit {name}] entry {eng.prefetch_entry},"
                                 f" layout {eng.spec.table_layout}")
        means = {h.spec.param: float(h.moments.mean[0])
                 for h in res.histograms if h.spec.yweight == "vol"}
        c = e.contribs
        means["half_length"] = (vol_mean(res, c[:, :, 0] * c[:, :, 1])
                                if bound.active[1] == "aspect" else None)
        key, want = PSI_GATED[name]
        if not abs(means[key] - want) <= 0.1 * want:
            raise AssertionError(f"[fit {name}] vol-weighted mean {key} "
                                 f"{means[key]!r}, golden {want!r}")
        misfit = psi_golden_misfit(torch, eng, data, PSI_GOLDEN[name])
        win, err, seg = k2_segment(torch, mc_kernel, f"K2 {name}", eng,
                                   card)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        histogram_all(e.contribs, data, bound, cfg, None, device=eng.device)
        torch.cuda.synchronize()
        post_s = time.perf_counter() - t0
        median = float(np.median(walls))
        print(f"[fit {name}] {int(e.converged.sum())}/10 converged, chi2 "
              f"{chi0.min():.1f}-{chi0.max():.1f} -> {e.conval.min():.4f}-"
              f"{e.conval.max():.4f} (held to "
              f"{'<= 1' if name in PSI_CONVERGES else 'descent'}), attempts "
              f"{e.attempts.tolist()}, launches (table in, rows in, K1) "
              f"{counts} (2 table axes, {eng.kern.table.values.shape[0]} "
              f"rows), total_iters {e.total_iters}, cold wall with the "
              f"probe and the bake {cold:.4f} s, warm walls of 5 fits "
              f"{walls}, median {median:.4f} s (engine {e.elapsed:.4f} s, "
              f"{e.total_iters / e.elapsed:.4g} proposals/s); post pass "
              f"and histograms {post_s:.4f} s; the table's blend at the "
              f"golden's parameters against the exact rule, |dff2|/ff2 max "
              f"{misfit[0]:.4g}, rms {misfit[1]:.4g}; vol-weighted means "
              f"{means} "
              f"(gated: {key} within 10 % of {want!r}); on {card}",
              flush=True)
        if profiling:
            profile_fit(torch, lambda: fit(data, bound, cfg, device="cuda"),
                        card, name, "mc_prefetch")
        out[name] = dict(seg, launches=counts[0], max_abs_err=err,
                         compared=win, median=median,
                         total_iters=e.total_iters)
    with table_env(32):
        for model in ("CylindersIsotropicAspect",
                      "CylindersRadiallyIsotropic"):
            win, worst = check_k2_ragged(
                torch, mc_kernel, engine_cls, load, data_config, get_model,
                suite.PSI_ROWS["cylinders-aspect"].config(), card,
                model=model, tag=f"K2 psi {model}")
            out[model] = dict(compared=win, max_abs_err=worst)
            print(f"[psi ragged] K2 on {model}'s tables (32 nodes an axis) "
                  f"against its plain versions at {len(K2_RAGGED)} ragged "
                  f"shapes x 2 proposal modes x 2 entries: max |chi2 kernel "
                  f"- plain| {worst}; {card}", flush=True)
        row = suite.PSI_ROWS["cylinders-radial"]
        data = row.load()
        bound = get_model(row.model).bind(
            active=("radius", "aspect", "psiAngle"),
            active_ranges={"radius": (1e-9, 1e-8), "aspect": (1.0, 4.0)})
        eng = engine_cls(data, bound, row.config(), device="cuda")
        if not (eng.prefetch_entry == "rows"
                and len(eng.kern.table.axes) == 3):
            raise AssertionError("[psi 3 axes] not the rows-in entry")
        eng.gen.manual_seed(2)
        state = eng._init_batch()
        gen_state = eng.gen.get_state()
        cands = mc_kernel.segment_candidates(
            state, 0, eng.spec, eng._draw_chunk_proposals(eng.seg_steps))
        ts, _ = mc_kernel.prefetch_table_reference(
            state.clone(), 0, eng.consts, eng.spec, cands)
        eng.gen.set_state(gen_state)
        reset_counts(mc_kernel)
        ks, _ = eng._segment(state.clone(), 0)
        torch.cuda.synchronize()
        if (mc_kernel.run_prefetch_chunk.launches,
                mc_kernel.run_prefetch_table_chunk.launches) != (1, 0):
            raise AssertionError("[psi 3 axes] launches")
        states_equal(torch, "psi 3 axes rows in", ks, ts)
        if not (ks.n_moves > 0).all():
            raise AssertionError("[psi 3 axes] a repetition accepted "
                                 "nothing")
        print(f"[psi 3 axes] CylindersRadiallyIsotropic with radius, aspect "
              f"and psiAngle active ({eng.kern.table.values.shape[0]}-row "
              f"table, 3 axes): the engine's {eng.seg_steps}-step segment "
              f"at R=10 N=300 K=128 launches K2's rows-in entry, bit for "
              f"bit its plain version; {card}", flush=True)
    psi_bake_blocks(torch, cylinders, tables, card)
    return out


def declined_route_phase(torch, mc_kernel, engine_cls, get_model, suite,
                         card):
    """Phase 19: the configurations no kernel runs — the ψ tables the
    probe declines (both models on the wide default ranges, 0.5-300 nm)
    and the tilted model, which has no table: at the ψ rows' shape (R=10,
    N=300, K=128, Nq=100) the engine raises under use_pallas='auto',
    naming the reason and use_pallas='off'; under 'off' the plain chunk
    runs a bounded number of steps (the verbatim 303-node rule in the
    loop), descends, launches nothing, and the phase prints the us a
    step."""
    nm = 1e-9
    cases = (
        ("CylindersIsotropicAspect", ("radius", "aspect"),
         {"radius": (0.5 * nm, 300 * nm), "aspect": (1.0, 20.0)},
         "declined", 8),
        ("CylindersRadiallyIsotropic", ("radius", "psiAngle"),
         {"radius": (0.5 * nm, 300 * nm)}, "declined", 8),
        ("CylindersRadiallyIsotropicTilted", ("radius", "psiAngle"),
         {"radius": (1.0, 20.0)}, "no device function", 4))
    out = {}
    row = suite.PSI_ROWS["cylinders-radial"]
    data = row.load()
    for name, active, ranges, reason, steps in cases:
        bound = get_model(name).bind(active=active, active_ranges=ranges)
        cfg = row.config(chunk_steps=steps)
        try:
            engine_cls(data, bound, cfg, device="cuda")
        except ValueError as exc:
            text = str(exc)
            if reason not in text or "use_pallas='off'" not in text:
                raise AssertionError(f"[declined {name}] error text "
                                     f"{text!r}")
        else:
            raise AssertionError(f"[declined {name}] use_pallas='auto' on "
                                 "the card did not raise")
        eng = engine_cls(data, bound, cfg.replace(use_pallas="off"),
                         device="cuda")
        if eng.uses_table or eng.runs_cuda_kernel:
            raise AssertionError(f"[declined {name}] a table or a kernel")
        eng.gen.manual_seed(1)
        state0 = eng._init_batch()
        props = eng._draw_chunk_proposals(n_steps=steps)
        work = state0.clone()
        reset_counts(mc_kernel)
        ms = time_chunk(torch, lambda: mc_kernel.chunk_reference(
            work.copy_(state0), 0, eng.consts, eng.spec, props), 2)
        if (mc_kernel.run_chunk.launches
                or mc_kernel.run_prefetch_chunk.launches
                or mc_kernel.run_prefetch_table_chunk.launches):
            raise AssertionError(f"[declined {name}] a kernel launched")
        if not (torch.isfinite(work.conval).all()
                and (work.conval <= state0.conval).all()):
            raise AssertionError(f"[declined {name}] chi2 did not descend")
        us = ms * 1e3 / steps
        out[name] = us
        print(f"[declined {name}] {reason}: use_pallas='auto' raises on "
              f"the card; the plain chunk (use_pallas='off'), {steps} "
              f"steps at R=10 N=300 K=128 Nq={data.count} with the "
              f"verbatim {int(dict(bound.fixed)['psiAngleDivisions'])}-"
              f"node rule in the loop: {ms:.2f} ms, {us:.1f} us per step; "
              f"{card}", flush=True)
    return out


def two_d_phase(torch, mc_kernel, fit, engine_cls, suite, card, profiling):
    """Phase 20: the 2D (q, psi) fit 'cylinders-2d' (CylindersRadially-
    Isotropic on a 100 x 36 image, 300 x 10, K=128, 1024 steps an
    attempt): use_pallas='auto' raises on the card naming 2D; ``fit()``
    under 'off' runs the plain chunk, launches nothing, chi2 descends on
    every repetition, and the recovered orientation lands within 0.3 rad
    of psi0 (mod pi); the card's float64 post pass equals the CPU's to
    1e-10 relative, and is timed."""
    from mcsas_tpu_torch.post import histogram
    row = suite.PSI_ROWS["cylinders-2d"]
    data = row.load()
    bound = row.bound(data)
    cfg = row.config()
    try:
        engine_cls(data, bound, cfg.replace(use_pallas="auto"),
                   device="cuda")
    except ValueError as exc:
        if "2D" not in str(exc) or "use_pallas='off'" not in str(exc):
            raise AssertionError(f"[2d] error text {str(exc)!r}")
    else:
        raise AssertionError("[2d] use_pallas='auto' on the card did not "
                             "raise")
    eng = engine_cls(data, bound, cfg, device="cuda")
    eng.gen.manual_seed(cfg.seed)
    chi0 = eng._init_batch().conval.double().cpu().numpy()
    reset_counts(mc_kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(data, bound, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    e = res.engine
    if (mc_kernel.run_chunk.launches or mc_kernel.run_prefetch_chunk.launches
            or mc_kernel.run_prefetch_table_chunk.launches
            or e.used_pallas or e.used_table):
        raise AssertionError("[2d] a table or a kernel")
    if not (np.isfinite(e.conval).all() and (e.conval < chi0).all()):
        raise AssertionError(f"[2d] chi2 {e.conval} against the start "
                             f"{chi0}")
    delta = suite.orientation_error(e.contribs)
    if not delta < 0.3:
        raise AssertionError(f"[2d] orientation off by {delta:.3f} rad")
    c = e.contribs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_post = histogram._post_pass_f64(bound, data, cfg, c, device="cuda")
    torch.cuda.synchronize()
    post_ms = (time.perf_counter() - t0) * 1e3
    cpu_post = histogram._post_pass_f64(bound, data, cfg, c, device="cpu")
    worst = 0.0
    for a, b in zip(card_post, cpu_post):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        fin = np.isfinite(b)
        if not np.array_equal(np.isfinite(a), fin):
            raise AssertionError("[2d] post pass: finite entries differ")
        rel = np.abs(a - b)[fin] / np.maximum(np.abs(b[fin]), 1e-300)
        worst = max(worst, float(rel.max()) if rel.size else 0.0)
    if not worst <= 1e-10:
        raise AssertionError(f"[2d] post pass card vs CPU: {worst:.3g}")
    steps = e.total_iters // (cfg.num_reps * cfg.candidates_per_step)
    print(f"[2d] cylinders-2d ({data.count} pixels, 300 x 10, K=128, "
          f"budget {cfg.max_iterations // 128} steps an attempt) under "
          f"use_pallas='off' on the card: chi2 {chi0.min():.1f}-"
          f"{chi0.max():.1f} -> {e.conval.min():.3f}-{e.conval.max():.3f}, "
          f"{int(e.converged.sum())}/10 converged, attempts "
          f"{e.attempts.tolist()}, total_iters {e.total_iters} ({steps} "
          f"steps of 10 repetitions), wall {wall:.3f} s (engine "
          f"{e.elapsed:.3f} s, {e.elapsed * 1e6 / max(steps, 1):.1f} us per "
          f"step), orientation {suite.orientation(c):.4f} rad (psi0 "
          f"{suite.PSI0}, off by {delta:.4f}); float64 post pass on the "
          f"card {post_ms:.2f} ms, against the CPU's max rel {worst:.3g}; "
          f"{card}", flush=True)
    if profiling:
        profile_fit(torch, lambda: fit(data, bound, cfg, device="cuda"),
                    card, "cylinders-2d", "mc_")
    return dict(wall=wall, post_ms=post_ms, delta=delta)



# phase 21's Sphere series: the dataset, the same with I and σ scaled
# × 2 and × 0.5, and a byte copy of the first under another name
SERIES = (("sphere-x2", 2.0), ("sphere-x0.5", 0.5), ("sphere-copy", None))
CLI_FLAGS = ("--candidates", "128", "--local-moves", "0.5", "--seed",
             "2026", "--max-iter", "8e6", "--nolog")


def _output_set(written):
    """The files of one OutputFiles.write_all, each asserted present."""
    paths = [p for v in written.values()
             for p in (v if isinstance(v, list) else [v])]
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing or not {"settings", "fit", "distributions", "statistics",
                       "contributions"} <= set(written):
        raise AssertionError(f"output set incomplete: {sorted(written)}, "
                             f"missing {missing}")
    return paths


def _cli_files(out_dir):
    """The files one CLI run wrote under *out_dir* (one subdirectory),
    the output set's kinds asserted present."""
    import glob
    paths = glob.glob(os.path.join(out_dir, "*", "*"))
    kinds = {os.path.basename(p).rsplit("_", 1)[-1] for p in paths}
    want = {"fit.dat", "settings.cfg", "contributions.pickle", "log.txt",
            "radius.dat"}                     # radius.dat: stats_radius
    if not (want <= kinds and any(k.startswith("hist-") for k in kinds)):
        raise AssertionError(f"CLI output in {out_dir}: {sorted(kinds)}")
    return paths


def _held_converged(label, res):
    e = res.engine
    if not (e.converged.all() and e.conval.max() <= 1.0
            and np.isfinite(e.contribs).all()):
        raise AssertionError(f"{label}: {int(e.converged.sum())}/"
                             f"{len(e.converged)} converged, max chi2 "
                             f"{e.conval.max()}")


class series_probe:
    """Reads a run_files series from outside: the kernels each fit()
    launched and its wall, each write_all's wall and when it ended, and
    the engines built (api.fit, OutputFiles.write_all and the engine
    class api builds, wrapped for the block and restored after)."""

    def __init__(self, api, mc_kernel, engine_cls):
        self.api, self.mc, self.engine_cls = api, mc_kernel, engine_cls
        self.fits, self.writes, self.ends, self.engines = [], [], [], []

    def _k2(self):
        return (self.mc.run_prefetch_table_chunk.launches
                + self.mc.run_prefetch_chunk.launches)

    def __enter__(self):
        api, probe = self.api, self
        self.saved = (api.fit, api.OutputFiles.write_all, api.McSASEngine)
        fit, write_all, engine_cls = self.saved

        def counted_fit(*args, **kw):
            k1, k2 = probe.mc.run_chunk.launches, probe._k2()
            t0 = time.perf_counter()
            res = fit(*args, **kw)
            probe.fits.append((probe.mc.run_chunk.launches - k1,
                               probe._k2() - k2, time.perf_counter() - t0))
            return res

        def timed_write_all(out, plot=False):
            t0 = time.perf_counter()
            written = write_all(out, plot=plot)
            t1 = time.perf_counter()
            probe.writes.append(t1 - t0)
            probe.ends.append(t1)
            return written

        class Counted(engine_cls):
            def __init__(self, *args, **kw):
                probe.engines.append(self)
                super().__init__(*args, **kw)

        api.fit, api.OutputFiles.write_all = counted_fit, timed_write_all
        api.McSASEngine = Counted
        return self

    def __exit__(self, *exc):
        (self.api.fit, self.api.OutputFiles.write_all,
         self.api.McSASEngine) = self.saved


def files_phase(torch, mc_kernel, card):
    """Phase 21: run_files over a Sphere series (K1) and the cylinder
    golden (K2), cli.main and ``python -m mcsas_tpu_torch``, at the
    headline width; returns the launches of K1 and K2."""
    import glob
    import shutil
    import tempfile
    from mcsas_tpu_torch import api, cli
    from mcsas_tpu_torch.config import McSASConfig
    from mcsas_tpu_torch.core.engine import McSASEngine
    from mcsas_tpu_torch.data import DataConfig
    from mcsas_tpu_torch.io import load_raw, write_ascii
    from mcsas_tpu_torch.tools import suite
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        # ---- the Sphere series through K1
        raw, _ = load_raw(DATA)
        files = [DATA]
        for name, factor in SERIES:
            fn = os.path.join(tmp, f"{name}.dat")
            if factor is None:
                shutil.copyfile(DATA, fn)
            else:
                scaled = np.array(raw, np.float64)
                scaled[:, 1:3] *= factor
                write_ascii(fn, scaled)
            files.append(fn)
        cfg = headline_config(McSASConfig).replace(series_stats=True)
        out_dir = os.path.join(tmp, "series")
        os.makedirs(out_dir)
        api._ENGINE_CACHE.clear()
        reset_counts(mc_kernel)
        with series_probe(api, mc_kernel, McSASEngine) as probe:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = api.run_files(files, "Sphere", cfg, out_dir=out_dir,
                                    device="cuda")
        k1_series = mc_kernel.run_chunk.launches
        k2_series = (mc_kernel.run_prefetch_table_chunk.launches
                     + mc_kernel.run_prefetch_chunk.launches)
        for fn, res in zip(files, results):
            _held_converged(f"series {os.path.basename(fn)}", res)
        per_file_k1 = [k1 for k1, _, _ in probe.fits]
        if (k2_series or any(k2 for _, k2, _ in probe.fits)
                or min(per_file_k1) <= 0
                or sum(per_file_k1) != k1_series):
            raise AssertionError(f"series: K1 launches per file "
                                 f"{per_file_k1}, K2 {k2_series}")
        if len(probe.engines) != 3:
            raise AssertionError(f"series: {len(probe.engines)} engines "
                                 "built for 4 files (3 contents)")
        if not np.array_equal(results[3].engine.contribs,
                              results[0].engine.contribs):
            raise AssertionError("series: the byte copy's contributions "
                                 "differ from the first file's")
        n_files = 0
        for res in results:
            n_files += len(_output_set(res.output_files))
            fitted, _ = load_raw(res.output_files["fit"])
            if not (np.allclose(fitted[:, 0], res.fit_x0, rtol=1e-6,
                                atol=0)
                    and np.allclose(fitted[:, 3], res.fit_measval_mean,
                                    rtol=1e-6, atol=0)):
                raise AssertionError("series: fit.dat differs from the "
                                     "in-memory fit_measval_mean")
        series_tables = glob.glob(os.path.join(out_dir,
                                               "series statistics *.dat"))
        n_hist = len(results[0].histograms)
        if len(series_tables) != 1:
            raise AssertionError(f"series: {len(series_tables)} tables")
        with open(series_tables[0], encoding="utf-8") as fd:
            rows = fd.read().strip().splitlines()[1:]
        if len(rows) != 4 * n_hist:
            raise AssertionError(f"series table: {len(rows)} rows, want "
                                 f"4 x {n_hist}")
        try:
            import h5py  # noqa: F401
            have_h5py = True
        except ImportError:
            have_h5py = False
        if have_h5py:
            from mcsas_tpu_torch.io.hdf import load_archive
            for res in results:
                state = load_archive(res.output_files["archive"])
                if not np.array_equal(state["contribs"], res.contribs):
                    raise AssertionError("series: the archive reloads to "
                                         "other contributions")
            archive = "written, and reloads to the same contributions"
        elif any("archive" in r.output_files for r in results):
            raise AssertionError("an archive was written without h5py")
        else:
            archive = "not written (h5py is not importable here)"
        walls = np.diff([t0] + probe.ends)
        conv = [f"{int(r.engine.converged.sum())}/{cfg.num_reps}"
                for r in results]
        print(f"[files] Sphere series through run_files: 4 files, "
              f"converged {conv} (max chi2 "
              f"{max(r.engine.conval.max() for r in results):.4f}), K1 "
              f"launches per file {per_file_k1}, K2 0, 3 engines built for"
              f" 4 files, the copy bitwise equal to the first, {n_files} "
              f"output files, series table {len(rows)} rows; HDF5 archive "
              f"{archive}", flush=True)
        print(f"[time files] per-file wall of the series (load, fit, "
              f"writes) {[round(float(w), 4) for w in walls]} s: first "
              f"file with engine set-up {walls[0]:.4f} s, the cached copy "
              f"{walls[3]:.4f} s; fit() alone "
              f"{[round(f[2], 4) for f in probe.fits]} s; write_all alone "
              f"{[round(w, 4) for w in probe.writes]} s (median "
              f"{float(np.median(probe.writes)) * 1e3:.2f} ms); on {card}",
              flush=True)

        # ---- the cylinder golden from a file through K2
        golden = suite.cylinder_golden()
        cyl_file = os.path.join(tmp, "synthetic-cylinder.dat")
        write_ascii(cyl_file, golden.raw)
        reset_counts(mc_kernel)
        t0 = time.perf_counter()
        (cres,) = api.run_files(
            [cyl_file], suite.cylinder_bound(), suite.cylinder_config(),
            out_dir=os.path.join(tmp, "cylinder"),
            data_config=DataConfig(n_bin=0), device="cuda")
        cyl_wall = time.perf_counter() - t0
        k2_cyl = mc_kernel.run_prefetch_table_chunk.launches
        _held_converged("cylinder file", cres)
        _output_set(cres.output_files)
        if (k2_cyl <= 0 or mc_kernel.run_prefetch_chunk.launches
                or mc_kernel.run_chunk.launches):
            raise AssertionError(
                f"cylinder file: {k2_cyl} launches of K2's table entry, "
                f"{mc_kernel.run_prefetch_chunk.launches} of its rows "
                f"entry, {mc_kernel.run_chunk.launches} of K1")
        mean_r = float(cres.histograms[0].moments.mean[0])
        if not abs(mean_r - GOLDEN_RADIUS) <= 0.1 * GOLDEN_RADIUS:
            raise AssertionError(f"cylinder file: vol-weighted mean radius "
                                 f"{mean_r!r} m, golden {GOLDEN_RADIUS} m")
        print(f"[files] cylinder golden through run_files: "
              f"{int(cres.engine.converged.sum())}/"
              f"{len(cres.engine.converged)} converged, max chi2 "
              f"{cres.engine.conval.max():.4f}, "
              f"{k2_cyl} launches of K2's table entry, mean radius "
              f"{mean_r * 1e9:.4f} nm (golden 10), wall with the bake "
              f"{cyl_wall:.4f} s; on {card}", flush=True)

        # ---- the CLI, in this process and as the module entry
        cli_dir = os.path.join(tmp, "cli")
        reset_counts(mc_kernel)
        rc = cli.main([DATA, *CLI_FLAGS, "-o", cli_dir])
        k1_cli = mc_kernel.run_chunk.launches
        cli_out = _cli_files(cli_dir)
        if rc != 0 or k1_cli <= 0:
            raise AssertionError(f"cli.main: rc {rc}, {k1_cli} K1 "
                                 "launches")
        sub_dir = os.path.join(tmp, "module")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (HERE, env.get("PYTHONPATH", "")) if p)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "mcsas_tpu_torch", DATA, *CLI_FLAGS,
             "-o", sub_dir], cwd=HERE, env=env, capture_output=True,
            text=True, timeout=600)
        sub_wall = time.perf_counter() - t0
        summary = [ln for ln in out.stdout.splitlines()
                   if ln.startswith("sasfit_sphere-10-1: chi2=")]
        if (out.returncode != 0 or len(summary) != 1
                or "[converged]" not in summary[0]):
            raise AssertionError(
                f"python -m mcsas_tpu_torch: rc {out.returncode}, summary "
                f"{summary}; stderr {out.stderr[-2000:]}")
        _cli_files(sub_dir)
        print(f"[files] cli.main rc 0, {k1_cli} K1 launches, "
              f"{len(cli_out)} files; python -m mcsas_tpu_torch rc 0: "
              f"{summary[0]}", flush=True)
        print(f"[time files] python -m mcsas_tpu_torch subprocess wall "
              f"{sub_wall:.4f} s (interpreter, torch import, kernel "
              f"libraries loaded, one headline fit, writes); phase 21 "
              f"{time.perf_counter() - t_phase:.2f} s; on {card}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"k1": k1_series + k1_cli, "k2": k2_cyl}


def contribs_match(label, res, base):
    """The JAX package's near-tie rule (tests/test_sharding.py:39-60):
    exact contributions, or every repetition but one bitwise equal and
    the sorted chi2 within 2e-2.  Returns the repetitions equal."""
    same = [np.array_equal(a, b) for a, b in zip(res.contribs,
                                                  base.contribs)]
    if all(same):
        return len(same)
    if sum(same) < max(1, len(same) - 1) or not np.allclose(
            np.sort(res.conval), np.sort(base.conval), rtol=2e-2):
        raise AssertionError(f"{label}: {sum(same)}/{len(same)} "
                             "repetitions equal, not a near-tie cascade")
    return sum(same)


def mesh_phase(torch, mc_kernel, fit, load, cfg, sphere_contribs,
               sphere_launches, sphere_median, cyl, cyl_contribs,
               cyl_launches, native_s, card):
    """Phase 22: the sharded ensemble on one card, the CLI's --mesh,
    profiling.trace and the native parser.  Returns the launches of K1
    and K2 per mesh."""
    import glob
    import shutil
    import tempfile
    from mcsas_tpu_torch import cli
    from mcsas_tpu_torch.core.engine import McSASEngine
    from mcsas_tpu_torch.io import ascii as ascii_mod
    from mcsas_tpu_torch.io import native
    from mcsas_tpu_torch.models import get_model
    from mcsas_tpu_torch.parallel import (ShardedEnsemble, make_mesh,
                                          rep_slices)
    from mcsas_tpu_torch.utils import profiling
    t_phase = time.perf_counter()
    dev0 = torch.device("cuda", 0)
    out = {}

    def sharded_fit(shape, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(*args, mesh=make_mesh(shape, [dev0] * shape[0]))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # ---- (a), (b): the Sphere headline on 2 and 3 repetition shards
    for shape in ((2, 1), (3, 1)):
        sharded_fit(shape, DATA, "Sphere", cfg)                 # cold
        reset_counts(mc_kernel)
        res, wall = sharded_fit(shape, DATA, "Sphere", cfg)
        k1 = mc_kernel.run_chunk.launches
        k2 = (mc_kernel.run_prefetch_table_chunk.launches
              + mc_kernel.run_prefetch_chunk.launches)
        walls = [wall] + [sharded_fit(shape, DATA, "Sphere", cfg)[1]
                          for _ in range(4)]
        _held_converged(f"mesh {shape} Sphere", res)
        if not np.array_equal(res.engine.contribs, sphere_contribs):
            raise AssertionError(f"mesh {shape}: the Sphere contributions "
                                 "differ from phase 5's")
        if k1 != shape[0] * sphere_launches or k2:
            raise AssertionError(f"mesh {shape}: {k1} K1 launches (want "
                                 f"{shape[0]} x {sphere_launches}), {k2} "
                                 "of K2")
        out[f"{shape[0]}x1"] = k1
        reps = [sl.stop - sl.start for sl in rep_slices(
            cfg.num_reps, make_mesh(shape, [dev0] * shape[0]))]
        print(f"[mesh] Sphere headline on a {shape[0]}x1 mesh of one card "
              f"(repetitions {reps}): contributions bitwise equal to "
              f"phase 5, 10/10 converged, max chi2 "
              f"{res.engine.conval.max():.4f}, {k1} K1 launches "
              f"({shape[0]} x {sphere_launches}); warm walls of 5 "
              f"{walls}, median {float(np.median(walls)):.4f} s against "
              f"phase 5's {sphere_median:.4f} s; on {card}", flush=True)

    # ---- (c): the cylinder row on 2 repetition shards, K2's table entry
    golden, cyl_bound, cyl_cfg = cyl
    sharded_fit((2, 1), golden, cyl_bound, cyl_cfg)             # cold
    reset_counts(mc_kernel)
    cres, cwall = sharded_fit((2, 1), golden, cyl_bound, cyl_cfg)
    k2 = mc_kernel.run_prefetch_table_chunk.launches
    if (mc_kernel.run_chunk.launches or mc_kernel.run_prefetch_chunk.launches
            or k2 != 2 * cyl_launches):
        raise AssertionError(f"mesh 2x1 cylinder: {k2} launches of K2's "
                             f"table entry (want 2 x {cyl_launches})")
    _held_converged("mesh 2x1 cylinder", cres)
    if not np.array_equal(cres.engine.contribs, cyl_contribs):
        raise AssertionError("mesh 2x1: the cylinder contributions differ "
                             "from phase 7's")
    cwalls = [cwall] + [sharded_fit((2, 1), golden, cyl_bound, cyl_cfg)[1]
                        for _ in range(4)]
    out["k2_2x1"] = k2
    print(f"[mesh] cylinder row on a 2x1 mesh of one card: contributions "
          f"bitwise equal to phase 7, {k2} launches of K2's table entry "
          f"(2 x {cyl_launches}); warm walls of 5 {cwalls}, median "
          f"{float(np.median(cwalls)):.4f} s; on {card}", flush=True)

    # ---- (d): the q axis, the plain chunk only
    bound = get_model("Sphere").bind()
    data = load(DATA)
    qcfg = cfg.replace(use_pallas="off", chunk_steps=1024, max_retries=0,
                       max_iterations=1024 * cfg.candidates_per_step,
                       show_incomplete=True)
    try:
        ShardedEnsemble(data, bound, cfg, mesh=make_mesh((1, 2), [dev0] * 2))
    except ValueError as e:
        if "q axis" not in str(e):
            raise
        print(f"[mesh] q axis under use_pallas='auto' raises: {e}",
              flush=True)
    else:
        raise AssertionError("a 1x2 mesh under 'auto' did not raise")
    plain = McSASEngine(data, bound, qcfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = plain.run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    qeng = ShardedEnsemble(data, bound, qcfg,
                           mesh=make_mesh((1, 2), [dev0] * 2))
    qeng.gen.manual_seed(qcfg.seed)
    start = qeng.whole_state(qeng._init_batch()).conval.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qres = qeng.run()
    torch.cuda.synchronize()
    q_wall = time.perf_counter() - t0
    if not (np.isfinite(qres.conval).all() and (qres.conval < start).all()
            and (qres.n_moves > 0).all()):
        raise AssertionError(f"q-sharded plain chunk did not descend: "
                             f"{start} -> {qres.conval}")
    same = contribs_match("mesh 1x2 plain chunk", qres, base)
    print(f"[mesh] Sphere headline on a 1x2 (q) mesh under "
          f"use_pallas='off', 1024 steps: chi2 {start.min():.4g}-"
          f"{start.max():.4g} -> {qres.conval.min():.4g}-"
          f"{qres.conval.max():.4g}, {same}/10 repetitions equal to the "
          f"unsharded plain chunk (near-tie rule); "
          f"{q_wall * 1e3 / 1024:.3f} ms a step against "
          f"{plain_wall * 1e3 / 1024:.3f} ms unsharded (walls {q_wall:.3f}"
          f" / {plain_wall:.3f} s); on {card}", flush=True)
    # the chunks alone, without the engine around them: 64 steps each
    # from one start state, CUDA events
    props = plain._draw_chunk_proposals(64)
    s0 = plain._init_batch()
    work = s0.clone()
    sh = qeng.shards[0]
    cells0 = qeng.shard_state(s0)[0]
    cells = [c.clone() for c in cells0]
    un_ms = time_chunk(torch, lambda: mc_kernel.chunk_reference(
        work.copy_(s0), 0, plain.consts, plain.spec, props), 2) / 64
    q_ms = time_chunk(torch, lambda: mc_kernel.chunk_reference(
        [w.copy_(c) for w, c in zip(cells, cells0)], 0, list(sh.consts),
        list(sh.specs), props), 2) / 64
    print(f"[time] plain chunk alone, 64 steps at the headline shape "
          f"(reset copy included): unsharded {un_ms:.3f} ms a step, "
          f"on the 1x2 (q) mesh {q_ms:.3f} ms a step; on {card}",
          flush=True)
    out["q_ms_step"] = q_wall * 1e3 / 1024
    out["plain_ms_step"] = plain_wall * 1e3 / 1024

    # ---- (e): mesh errors on one card, the CLI's --mesh
    n_cards = torch.cuda.device_count()
    try:
        make_mesh((n_cards + 1, 1))
    except ValueError as e:
        print(f"[mesh] make_mesh(({n_cards + 1}, 1)) on {n_cards} card(s) "
              f"raises: {e}", flush=True)
    else:
        raise AssertionError("a mesh larger than the cards did not raise")
    tmp = tempfile.mkdtemp(prefix="mcsas_mesh_")
    try:
        reset_counts(mc_kernel)
        rc = cli.main([DATA, *CLI_FLAGS, "-o", os.path.join(tmp, "cli"),
                       "--mesh", "1"])
        k1_cli = mc_kernel.run_chunk.launches
        _cli_files(os.path.join(tmp, "cli"))
        if rc != 0 or k1_cli != sphere_launches:
            raise AssertionError(f"cli --mesh 1: rc {rc}, {k1_cli} K1 "
                                 f"launches (want {sphere_launches})")
        rc_big = cli.main([DATA, *CLI_FLAGS, "-o", os.path.join(tmp, "x"),
                           "--mesh", str(n_cards + 1)])
        if rc_big != 2:
            raise AssertionError(f"cli --mesh {n_cards + 1}: rc {rc_big}")
        print(f"[mesh] cli --mesh 1: rc 0, {k1_cli} K1 launches; --mesh "
              f"{n_cards + 1}: rc 2", flush=True)

        # ---- (f): profiling.trace of one headline fit
        with profiling.trace(os.path.join(tmp, "trace")):
            with profiling.annotate("headline fit"):
                fit(DATA, "Sphere", cfg, device="cuda")
            torch.cuda.synchronize()
        traces = glob.glob(os.path.join(tmp, "trace", "*.json"))
        with open(traces[0], encoding="utf-8") as fd:
            text = fd.read()
        if len(traces) != 1 or '"headline fit"' not in text:
            raise AssertionError(f"profiling.trace wrote {traces}")
        print(f"[profile] utils.profiling.trace of one headline fit: "
              f"{os.path.basename(traces[0])}, {len(text)} bytes, the "
              f"annotated span inside", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- (g): the native ASCII parser (built in phase 2)
    lib = native.build()
    checked = 0
    for fn in sorted(glob.glob(os.path.join(HERE, "testdata", "*.dat"))
                     + glob.glob(os.path.join(HERE, "testdata", "*.csv"))):
        try:
            py = ascii_mod.load_ascii(fn, use_native=False)
        except ascii_mod.FileReadError:
            continue
        if ascii_mod.load_ascii(fn, use_native=True).tobytes() != \
                py.tobytes():
            raise AssertionError(f"native parser differs on {fn}")
        checked += 1
    if checked < 15:
        raise AssertionError(f"native parser: only {checked} files parsed")
    print(f"[native] {lib.name} built in {native_s:.2f} s; {checked} "
          f"testdata files parsed byte for byte as the Python parser; "
          f"phase 22 {time.perf_counter() - t_phase:.2f} s; on {card}",
          flush=True)
    return out


def kern_probe_entries():
    """The K2 entries of the probe's runner (tools/kern_probe.py)."""
    from mcsas_tpu_torch.tools import kern_probe
    return kern_probe.K2_ENTRIES


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
    from mcsas_tpu_torch.data import DataConfig, TrapezoidSmearing
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
    # the native ASCII parser, built by the host C++ compiler before the
    # first data file is read
    from mcsas_tpu_torch.io import native
    t0 = time.perf_counter()
    native_lib = native.build()
    native_s = time.perf_counter() - t0
    print(f"[build] {native_lib.name}: host C++ compiler {native_s:.2f} s",
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
    for entry in kern_probe_entries():
        by_lv = {r["level"]: r["us_per_step"] for r in probe["rungs"]
                 if r.get("kernel") == "K2" and r["entry"] == entry}
        tail = " in" if entry in ("rows", "table") else ""
        print(f"[probe] K2 {entry}{tail}, "
              f"us per step by rung: "
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

    # ---- phase 11: the smeared cylinder main path
    smeared_launches, sgolden, sbound, scfg = smeared_cylinder_phase(
        torch, mc_kernel, fit, McSASEngine, histogram_all, suite, card,
        profiling)

    # ---- phase 12: K2's table entry with the intensity row
    k2_int = intensity_kernel_phase(
        torch, mc_kernel, McSASEngine, load, DataConfig, get_model,
        TrapezoidSmearing, sgolden, sbound, scfg, card)

    # ---- phase 13: the repaired route (tables the table entry cannot blend)
    route_phase(torch, mc_kernel, fit, McSASEngine, suite, ce.contribs, card)

    # ---- phase 14: the smeared Sphere path (the plain chunk)
    smeared_sphere_phase(torch, mc_kernel, fit, McSASEngine, load,
                         DataConfig, TrapezoidSmearing, get_model, cfg,
                         suite, card)

    # ---- phase 15: the table rows (ellipsoid, core-shell ellipsoid, worm)
    table_rows = table_rows_phase(torch, mc_kernel, fit, McSASEngine,
                                  histogram_all, suite, card, profiling)

    # ---- phase 16: K2's table entry with the worm's cross-section factor
    xs_windows, xs_err, xs_raw = factor_kernel_phase(
        torch, mc_kernel, McSASEngine, load, DataConfig, TrapezoidSmearing,
        get_model, suite, card)

    # ---- phase 17: the reference's joint cylinder run, K2 at two axes
    crossval_launches = cylinder_crossval_phase(torch, mc_kernel, fit, suite,
                                                card)

    # ---- phase 18: the ψ-grid cylinders' table rows through K2's table entry
    psi_rows = psi_table_rows_phase(torch, mc_kernel, fit, McSASEngine,
                                    histogram_all, load, DataConfig,
                                    get_model, suite, card, profiling)

    # ---- phase 19: the declined ψ tables and the tilted model (no kernel)
    declined_route_phase(torch, mc_kernel, McSASEngine, get_model, suite,
                         card)

    # ---- phase 20: 2D (q, ψ) fitting through the plain chunk
    two_d_phase(torch, mc_kernel, fit, McSASEngine, suite, card, profiling)

    # ---- phase 21: the result files, run_files and the CLI
    files = files_phase(torch, mc_kernel, card)

    # ---- phase 22: the sharded ensemble, profiling, the native parser
    mesh = mesh_phase(torch, mc_kernel, fit, load, cfg, e.contribs, launches,
                      float(np.median(walls)),
                      (golden, cyl_bound, cyl_cfg), ce.contribs, k2_launches,
                      native_s, card)

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
        "files_launches": files["k1"],
        "rep_base": "Philox keyed by (seed, rep_base + r); launched once a "
                    "chunk per repetition shard (phase 22)",
        "mesh_launches": {k: mesh[k] for k in ("2x1", "3x1")},
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
        "files_launches": files["k2"],
        "mesh_launches": {"2x1": mesh["k2_2x1"]},
        "rows_in": k2["rows"], "compared": k2_windows})
    kernels.append({
        "name": "mc_prefetch[intensity]", "route": "cuda",
        "source": "mcsas_tpu_torch/csrc/mc_prefetch.cu",
        "replaces": "mcsas_tpu/ops/mc_kernel.py:719",
        "launches": smeared_launches, "max_abs_err": k2_int["max_abs_err"],
        "ms": k2_int["ms"], "plain_ms": k2_int["plain_ms"],
        "bound_ms": k2_int["bound_ms"], "bound_by": k2_int["bound_by"],
        "library_ms": None, "shape": k2_int["shape"],
        "entry": "table in, intensity rows (the smeared fit path)",
        "compared": k2_int["compared"]})
    worm = table_rows["kholodenko-worm"]
    kernels.append({
        "name": "mc_prefetch[cross-section]", "route": "cuda",
        "source": "mcsas_tpu_torch/csrc/mc_prefetch.cu",
        "replaces": "mcsas_tpu/ops/mc_kernel.py:719",
        "launches": worm["launches"],
        "max_abs_err": max(worm["max_abs_err"], xs_err),
        "ms": worm["ms"], "plain_ms": worm["plain_ms"],
        "bound_ms": worm["bound_ms"], "bound_by": worm["bound_by"],
        "library_ms": None, "shape": worm["shape"],
        "entry": "table in, the worm's cross-section of each point (the "
                 "kholodenko-worm fit path)",
        "table_source": {k: xs_raw[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "shape")},
        "compared": worm["compared"] + xs_windows})
    ecs = table_rows["core-shell-ellipsoid"]
    kernels.append({
        "name": "mc_prefetch[2 axes]", "route": "cuda",
        "source": "mcsas_tpu_torch/csrc/mc_prefetch.cu",
        "replaces": "mcsas_tpu/ops/mc_kernel.py:719",
        "launches": ecs["launches"], "max_abs_err": ecs["max_abs_err"],
        "ms": ecs["ms"], "plain_ms": ecs["plain_ms"],
        "bound_ms": ecs["bound_ms"], "bound_by": ecs["bound_by"],
        "library_ms": None, "shape": ecs["shape"],
        "entry": "table in, two table axes (the core-shell-ellipsoid fit "
                 "path; the joint cylinder crossval: "
                 f"{crossval_launches} launches)",
        "compared": ecs["compared"]})
    ell = table_rows["ellipsoids-isotropic"]
    kernels.append({
        "name": "mc_prefetch[EllipsoidsIsotropic]", "route": "cuda",
        "source": "mcsas_tpu_torch/csrc/mc_prefetch.cu",
        "replaces": "mcsas_tpu/ops/mc_kernel.py:719",
        "launches": ell["launches"], "max_abs_err": ell["max_abs_err"],
        "ms": ell["ms"], "plain_ms": ell["plain_ms"],
        "bound_ms": ell["bound_ms"], "bound_by": ell["bound_by"],
        "library_ms": None, "shape": ell["shape"],
        "entry": "table in, one table axis (the ellipsoids-isotropic fit "
                 "path)",
        "compared": ell["compared"]})
    for name, model in (("cylinders-aspect", "CylindersIsotropicAspect"),
                        ("cylinders-radial", "CylindersRadiallyIsotropic")):
        k = psi_rows[name]
        kernels.append({
            "name": f"mc_prefetch[psi table, {model}]", "route": "cuda",
            "source": "mcsas_tpu_torch/csrc/mc_prefetch.cu",
            "replaces": "mcsas_tpu/ops/mc_kernel.py:719",
            "launches": k["launches"],
            "max_abs_err": max(k["max_abs_err"],
                               psi_rows[model]["max_abs_err"]),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "shape": k["shape"],
            "entry": f"table in, a probe-gated psi table of two axes (the "
                     f"{name} fit path)",
            "compared": k["compared"] + psi_rows[model]["compared"]})
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
