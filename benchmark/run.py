"""Runs one cell of BENCHMARK.json once, on the card:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A closed loop with one worker: set-up (imports, the card, the kernel
library, the tables, the frame basis, two warm-up fits on frames outside
the measured sequence; its split is printed on an earlier line), then a
new frame from the traffic's generator and one ``fit()`` after another
for ``--seconds``, then the check that decides ``correct`` (a sample of
the window's fits, drawn from the seed with the longest in it, against
the plain reference in float64 on the card), then one JSON line.  With
``--trace 1`` the window runs under torch.profiler, with the harness's
synchronized spans around engine construction, ``McSASEngine.run`` and
the post pass, and the line carries the per-layer metrics, the device's
busy time and a breakdown.

Without a card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result; so it does when the process holds JAX or
the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    # one process with one thread on the host: the runs of a cell spread
    # less (measured on the cylinder cells) and run no slower
    os.environ["OMP_NUM_THREADS"] = "1"

import numpy as np  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mcsas_tpu")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
# the harness's spans: engine construction, the MC run, the post pass,
# frame synthesis, one fit, the window
SPANS = ("api.setup", "engine.run", "post", "frame", "fit", "window")
SPAN_LABELS = {"api.setup": "engine set-up (api._cached_engine)",
               "engine.run": "engine run, between launches",
               "post": "post pass (api.histogram_all)",
               "frame": "frame synthesis and from_raw",
               "fit": "fit, outside the three layers",
               "window": "between fits"}
KERNEL_TAGS = ("mc_chunk", "mc_prefetch")       # K1, K2
# the profiler traces the window's first seconds: reading the trace of a
# whole 51-second window of the cylinder cell took minutes
TRACE_SECONDS = 15.0


# ------------------------------------------------------------ the layout

def _json(path):
    with open(path, encoding="utf-8") as fd:
        return json.load(fd)


def _named(kind, name):
    if not NAME.fullmatch(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def load_cell(name, root=ROOT):
    """Everything cell *name* of ``<root>/BENCHMARK.json`` names, found by
    name: its entry, its configuration's file, its traffic file and the
    generator that file names, its limits file and the metrics it reports
    (end-to-end and per-layer, each with its reader)."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = root / "benchmark"
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads",
                                                           [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name])
             and m["moves"] in reported]
    traffic = _json(here / "traffic"
                    / f"{_named('traffic', cell['traffic'])}.json")
    return {
        "cell": cell,
        "config": _json(root / conf["file"]),
        "traffic": traffic,
        "generator": generator(traffic["generator"], here),
        "limits": _json(here / "limits" / f"{_named('cell', name)}.json"),
        "end_to_end": [(m, reader(m["name"], here)) for m in e2e],
        "per_layer": [(m, reader(m["name"], here)) for m in layer],
    }


def _module(kind, name, here):
    path = here / f"{kind}s" / f"{_named(kind, name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{re.sub('[.-]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric, here=HERE):
    """The ``read(rec)`` of ``metrics/<metric>.py``."""
    return _module("metric", metric, here).read


def generator(name, here=HERE):
    """The ``FrameSource(traffic, seed, device)`` of
    ``generators/<name>.py``."""
    return _module("generator", name, here).FrameSource


# ------------------------------------------------------------ the program

def program_setup(config, traffic):
    """The program's objects for a cell: (api, bound, base config,
    DataConfig).  A configuration's ``modelFile`` names a user's model file,
    ``plugins/<modelFile>.py``, which the program's plugin loader
    (``--model-file``'s call) registers before the model is looked up."""
    from mcsas_tpu_torch import api
    from mcsas_tpu_torch.config import McSASConfig
    from mcsas_tpu_torch.data import DataConfig, TrapezoidSmearing
    from mcsas_tpu_torch.models import get_model, load_model_file
    if "modelFile" in config:
        name = _named("model file", config["modelFile"])
        load_model_file(str(HERE / "plugins" / f"{name}.py"))
    bound = get_model(config["model"]).bind(
        active=tuple(config["active"]),
        active_ranges={k: tuple(v) for k, v in
                       config["activeRanges"].items()},
        fixed=dict(config["fixed"]) or None)
    base = McSASConfig.from_dict(config)
    d = traffic["data"]
    sm = d.get("smearing")
    data_cfg = DataConfig(
        n_bin=d.get("n_bin", 100), fu_min=d.get("fu_min", 0.01),
        smearing=TrapezoidSmearing(do_smear=True, **sm) if sm else None)
    return api, bound, base, data_cfg


def outputs(res):
    """What the check judges of a fit's result (host numpy)."""
    e, fr = res.engine, res.fractions
    return {"contribs": e.contribs,
            "engine": {"conval": e.conval, "scaling": e.scaling,
                       "background": e.background},
            "post": {"scaling": fr.scaling, "measval": fr.measval,
                     "vol_fraction": fr.fraction["vol"],
                     "hist": res.histograms[0].bins.full}}


def work_shape(config, traffic, nq):
    """The sizes the op model prices a launch with, from the cell's files
    alone: the configuration, its frozen ``opmodel`` sizes of a table, and
    the traffic (*nq*: the length of the reference's fit grid)."""
    table = config.get("opmodel", {})
    return {"model": config["model"], "nq": int(nq),
            "reps": int(config["numReps"]),
            "contribs": int(config["numContribs"]),
            "params": len(config["active"]),
            "table_values": int(table.get("table_rows", 0)) * int(nq),
            "table_axes": int(table.get("table_axes", 0)),
            "intensity_table": bool(traffic["data"].get("smearing")),
            "cross_section": bool(table.get("cross_section", False))}


class Spans:
    """The harness's spans around the calls into each layer: synchronized
    on the card, each under a profiler annotation of its name."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.seconds = {name: [] for name in SPANS}

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def __call__(self, name):
        with self.torch.profiler.record_function(name):
            self.sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.sync()
                self.seconds[name].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def installed(self, api):
        """Wraps ``api._cached_engine``, ``McSASEngine.run`` and
        ``api.histogram_all`` while the scope lasts; results unchanged."""
        from mcsas_tpu_torch.core.engine import McSASEngine
        saved = (api._cached_engine, McSASEngine.run, api.histogram_all)

        def wrap(name, fn):
            def inner(*a, **kw):
                with self(name):
                    return fn(*a, **kw)
            return inner
        api._cached_engine = wrap("api.setup", saved[0])
        McSASEngine.run = wrap("engine.run", saved[1])
        api.histogram_all = wrap("post", saved[2])
        try:
            yield self
        finally:
            api._cached_engine, McSASEngine.run, api.histogram_all = saved


# ------------------------------------------------------------ the trace

def _event_tag(name):
    for tag in KERNEL_TAGS:
        if tag in name:
            return tag
    return None


def device_record(events, window=None):
    """Busy time, kernels and idle gaps of profiler *events* (objects with
    ``name``, ``device_type`` (``"cuda"`` or else), ``start_us`` and
    ``end_us``): device operations are the device-side events that are
    not the harness's annotations; the traced window is the ``window``
    span's (or *window* (start_us, end_us)); gaps are labelled by the
    innermost harness span that holds them.  ``engine_eager_s``: the
    device time of the operations, neither K1 nor K2, whose middle lies in
    an ``engine.run`` span (which synchronizes at entry and exit, so the
    run issued them)."""
    from . import stats
    dev, host = [], []
    for ev in events:
        if ev.device_type == "cuda":
            if ev.name not in SPANS:
                dev.append(ev)
        elif ev.name in SPANS:
            host.append((ev.name, ev.start_us, ev.end_us))
    if window is None:
        window = next((s, e) for n, s, e in host if n == "window")
    lo, hi = window
    ivs = [(ev.start_us, ev.end_us) for ev in dev]
    runs = sorted((s, e) for n, s, e in host if n == "engine.run")
    starts = [s for s, _ in runs]
    by_name, by_tag, eager = {}, {}, 0.0
    for ev in dev:
        t = (ev.end_us - ev.start_us) * 1e-6
        s, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (s + t, n + 1)
        tag = _event_tag(ev.name)
        if tag:
            s, n = by_tag.get(tag, (0.0, 0))
            by_tag[tag] = (s + t, n + 1)
        else:
            mid = 0.5 * (ev.start_us + ev.end_us)
            k = bisect.bisect_right(starts, mid) - 1
            if k >= 0 and mid <= runs[k][1]:
                eager += t
    idle = stats.label_gaps(stats.gaps(ivs, lo, hi), host)
    return {"busy_s": stats.busy_in(ivs, lo, hi) * 1e-6,
            "window_s": (hi - lo) * 1e-6,
            "kernels": by_name, "kernels_by_tag": by_tag,
            "idle_s": {SPAN_LABELS.get(k, k): v * 1e-6
                       for k, v in idle.items()},
            "engine_eager_s": eager}


class _Ev:
    __slots__ = ("name", "device_type", "start_us", "end_us")

    def __init__(self, name, device_type, start_us, end_us):
        self.name, self.device_type = name, device_type
        self.start_us, self.end_us = start_us, end_us


def profiler_events(prof):
    """The profiler's events as plain records (:class:`_Ev`), read from
    its raw results (building its event tree takes minutes on a window of
    fits)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [_Ev(ev.name(), "cuda" if ev.device_type() == cuda else "cpu",
                ev.start_ns() * 1e-3, ev.end_ns() * 1e-3)
            for ev in prof.profiler.kineto_results.events()]


def breakdown(dev):
    top = sorted(dev["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(dev["idle_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v[0]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


# ------------------------------------------------------------ one run

def run_cell(piece, seed, seconds, trace=False, device="cuda", control=False,
             t_start=T_START, marks=()):
    """One run of a cell (*piece* from :func:`load_cell`): returns the
    record the metrics read, with the checks and, with *control*, the
    control's readings (the reference in bfloat16 in the program's
    place).  *marks* are (name, time) of set-up's earlier phases, after
    *t_start*; the record's ``setup_split`` gives each phase's seconds."""
    import torch

    from .reference import core, prep
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks = [("start", t_start), *marks]

    def mark(name, synced=True):
        if synced:
            sync()
        marks.append((name, time.perf_counter()))
    config, traffic = piece["config"], piece["traffic"]
    api, bound, base, data_cfg = program_setup(config, traffic)
    from mcsas_tpu_torch.data import from_raw
    mark("the program's import", synced=False)
    torch.empty(1, device=device)
    mark("the card's context")
    src = piece["generator"](traffic, seed, device)
    mark("frame basis")

    def one_fit(i, prewarm=False):
        data = from_raw(src.frame(i), title=f"frame {i}", config=data_cfg)
        cfg = base.replace(seed=src.fit_seed(i))
        return api.fit(data, bound, cfg, device=device, prewarm=prewarm), data

    for i in (-1, -2):                       # outside the measured sequence
        res, data = one_fit(i, prewarm=True)
        mark(f"warm-up fit {i}")
    shape = work_shape(config, traffic,
                       len(prep.derive(src.frame(-1), traffic["data"])["q"]))
    spans = Spans(device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts), spans.installed(api):
            one_fit(-3)                      # the profiler's own first use
        spans = Spans(device)
        prof = profile(activities=acts)
        mark("the profiler's first use")
    span = spans if trace else (lambda name: contextlib.nullcontext())
    mark("the rest")
    fits, kept = [], []
    setup_s = marks[-1][1] - t_start
    frame_s = load_s = 0.0
    traced = contextlib.ExitStack()
    n_traced = None
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(spans.installed(api))
            prof.start()
            traced.callback(prof.stop)
            traced.enter_context(span("window"))
        t0 = time.perf_counter()
        while True:
            i = len(fits)
            f0 = time.perf_counter()
            with span("frame"):
                raw = src.frame(i)
                f1 = time.perf_counter()
                data = from_raw(raw, title=f"frame {i}", config=data_cfg)
            cfg = base.replace(seed=src.fit_seed(i))
            a = time.perf_counter()
            frame_s += f1 - f0
            load_s += a - f1
            with span("fit"):
                res = api.fit(data, bound, cfg, device=device)
                sync()
            b = time.perf_counter()
            fits.append({"i": i, "wall_s": b - a,
                         "converged": bool(res.engine.converged.all()),
                         "total_iters": int(res.engine.total_iters),
                         "engine_s": float(res.engine.elapsed)})
            kept.append(outputs(res))
            if trace and n_traced is None and (
                    b - t0 >= min(seconds, TRACE_SECONDS)):
                traced.close()
                n_traced = len(fits)
            if b - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    # the program keeps its last few engines (a small bounded cache of its
    # own); what the harness holds of the program goes
    del res, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rec = {"fits": fits, "window_s": window_s, "setup_s": setup_s,
           "setup_split": [(n, b - a) for (_, a), (n, b)
                           in zip(marks, marks[1:])],
           "frame_s": frame_s, "load_s": load_s, "shape": shape,
           "memory_peak_bytes": peak}
    if trace:
        rec["spans"] = {k: v for k, v in spans.seconds.items() if v}
        rec["device"] = device_record(profiler_events(prof))
        rec["device"]["fits"] = n_traced
        del prof
    # the check: a sample drawn from the seed, the longest fit in it
    rng = np.random.default_rng([int(seed) % 2 ** 64, 3])
    k = min(int(traffic["check_fits"]), len(fits))
    longest = max(range(len(fits)), key=lambda j: fits[j]["wall_s"])
    pick = sorted({longest, *rng.choice(len(fits), size=k, replace=False)
                   .tolist()})
    checks, ctrl = {}, {}
    crit = float(base.convergence_criterion)
    ctrl_failed = 0
    for j in pick:
        fg = prep.derive(src.frame(fits[j]["i"]), traffic["data"])
        out = kept[j]
        ref = core.reference(config, fg, out["contribs"], core.exact, device)
        judged = out["engine"]["conval"] <= crit
        for name, v in core.judge(out, ref, fg, judged).items():
            checks[name] = max(checks.get(name, 0.0), v or 0.0)
        if control:
            low = core.reference(config, fg, out["contribs"],
                                 core.bfloat16, device)
            ctrl_failed += bool((low["engine"]["conval"] > crit).any())
            for name, v in core.judge(low, ref, fg, judged).items():
                ctrl[name] = max(ctrl.get(name, 0.0), v or 0.0)
    checks["failed_share"] = sum(not f["converged"] for f in fits) / len(fits)
    rec["checks"] = checks
    rec["checked_fits"] = len(pick)
    if control:
        ctrl["failed_share"] = ctrl_failed / len(pick)
        rec["control"] = ctrl
    return rec


def passes(checks, limits):
    """True when every check is within its limit."""
    return all(checks[k] <= lim for k, lim in limits.items())


def result_line(piece, rec, trace, kind, count):
    """The result's JSON object: the cell's metrics of this kind of run,
    the device, and the checks last."""
    limits = piece["limits"]
    metrics = {}
    for m, read in (piece["per_layer"] if trace else piece["end_to_end"]):
        v = read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": kind, "count": count,
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    line = {"correct": passes(rec["checks"], limits),
            "attempted": len(rec["fits"]),
            "failed": sum(not f["converged"] for f in rec["fits"]),
            "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec["device"]["busy_s"]
        dev["window_s"] = rec["device"]["window_s"]
        line["breakdown"] = breakdown(rec["device"])
    line["checks"] = {k: {"value": rec["checks"][k], "limit": lim}
                      for k, lim in limits.items()}
    return line


def forbidden_modules():
    """Top-level names of sys.modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m benchmark.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def cache_env(root=ROOT):
    """Fixed cache directories inside the checkout: the program's table
    cache and, should anything use them, the torch extension and Triton
    caches."""
    cache = root / "benchmark" / ".cache"
    os.environ["MCSAS_TPU_TABLE_CACHE_DIR"] = str(cache / "tables")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None):
    args = build_parser().parse_args(argv)
    piece = load_cell(args.workload)
    import torch
    marks = [("interpreter, numpy, the harness's files, torch's import",
              time.perf_counter())]
    chips = int(piece["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark.run: {args.workload} needs {chips} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cache_env()
    torch.set_num_threads(1)
    kind = torch.cuda.get_device_name(0)
    marks.append(("CUDA's initialization", time.perf_counter()))
    rec = run_cell(piece, args.seed, args.seconds, trace=bool(args.trace),
                   marks=marks)
    found = forbidden_modules()
    if found:
        print(f"benchmark.run: the process holds {found} once the window "
              "has closed", file=sys.stderr)
        return 3
    fits = rec["fits"]
    rate = sum(f["converged"] for f in fits) / rec["window_s"]
    walls = sorted(f["wall_s"] for f in fits)
    print("set-up split (s): " + ", ".join(
        f"{n} {v!r}" for n, v in rec["setup_split"]))
    print(f"fit wall median {walls[len(walls) // 2]!r} s, engine run mean "
          f"{sum(f['engine_s'] for f in fits) / len(fits)!r} s")
    print(f"fits: {len(fits)} in {rec['window_s']:.6f} s, {rate} fits/s "
          f"{'traced' if args.trace else 'untraced'}; frame synthesis "
          f"{rec['frame_s']:.6f} s, {100 * rec['frame_s'] / rec['window_s']}"
          f" % of the window; from_raw {rec['load_s']:.6f} s; checked "
          f"{rec['checked_fits']} fits")
    line = result_line(piece, rec, bool(args.trace), kind, chips)
    sys.stdout.flush()
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
