# -*- coding: utf-8 -*-
"""Command-line entry point of the PyTorch port: the working headless
replacement for the reference's GUI-default main (src/mcsas/main.py:52-100,
whose text mode is marked broken at main.py:93), with the JAX package's
flags (mcsas_tpu/cli.py) and an explicit compute device.

    python -m mcsas_tpu_torch data.csv [-m Sphere] [-o outdir] [--plot] \
        [--device cuda|cpu] ...

The fits run on the card unless ``--device cpu`` asks for the CPU;
``--device cuda`` (the default) without a card is an error (exit code 2).
``--mesh REP[,Q]`` shards the ensemble over that many distinct devices of
``--device`` (``parallel.make_mesh``); a malformed or too large mesh is
an error too (exit code 2).  ``--prewarm`` pays the card's first-use
costs (kernel build and load, first launches) before the first fit.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

from .config import McSASConfig
from .core.engine import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mcsas_tpu_torch",
        description="Monte Carlo size-distribution retrieval for "
                    "small-angle scattering data on an NVIDIA GPU "
                    "(PyTorch/CUDA)")
    # nargs="*": --list-models must work without a data file; the
    # fit path validates non-emptiness itself
    p.add_argument("filenames", nargs="*", help="data files to fit")
    p.add_argument("-m", "--model", default="Sphere",
                   help="model name (see --list-models)")
    p.add_argument("-o", "--outdir", default=None,
                   help="output directory (default: beside each data file)")
    p.add_argument("-c", "--config", default=None,
                   help="JSON algorithm-config file (reference "
                        "mcsasparameters.json-style or flat)")
    p.add_argument("--contribs", type=int, default=None,
                   help="number of contributions (default 300)")
    p.add_argument("--reps", type=int, default=None,
                   help="number of repetitions (default 10)")
    p.add_argument("--max-iter", type=float, default=None,
                   help="max iterations per repetition (default 1e5)")
    p.add_argument("--candidates", type=int, default=None,
                   help="speculative proposals per MC step")
    p.add_argument("--local-moves", type=float, default=None,
                   help="fraction of candidates drawn as local "
                        "perturbations of the current value (0 = "
                        "reference proposal semantics; speeds narrow-"
                        "basin convergence)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--active", default=None,
                   help="comma-separated active parameter names")
    p.add_argument("--range", action="append", default=[],
                   metavar="PARAM=LO:HI",
                   help="active range override in display units, "
                        "repeatable")
    # data-settings page equivalents (reference gui datawidget/rangelist)
    p.add_argument("--qmin", type=float, default=None,
                   help="lower q limit in nm⁻¹")
    p.add_argument("--qmax", type=float, default=None,
                   help="upper q limit in nm⁻¹")
    p.add_argument("--nbin", type=int, default=None,
                   help="number of log-spaced data bins (0 disables)")
    p.add_argument("--fu-min", type=float, default=None,
                   help="minimum uncertainty as a fraction of I "
                        "(default 0.01)")
    p.add_argument("--mask-neg", action="store_true",
                   help="drop I<0 points")
    p.add_argument("--mask-zero", action="store_true",
                   help="drop I==0 points")
    p.add_argument("--smear-trapezoid", metavar="UMBRA:PENUMBRA",
                   default=None,
                   help="slit smearing with a trapezoidal beam profile "
                        "(widths in nm⁻¹)")
    p.add_argument("--smear-gaussian", metavar="SIGMA", type=float,
                   default=None,
                   help="smearing with a Gaussian beam profile (nm⁻¹)")
    p.add_argument("--smear-steps", type=int, default=25,
                   help="smearing integration points (default 25)")
    p.add_argument("--smear-2d", action="store_true",
                   help="2D-averaged (pinhole) data instead of "
                        "slit-smeared")
    p.add_argument("--plot", action="store_true",
                   help="write a result plot PDF")
    p.add_argument("--rehistogram", action="store_true",
                   help="treat inputs as HDF5 archives from a previous "
                        "run: recompute histograms from the stored "
                        "contributions without re-fitting")
    p.add_argument("--bins", type=int, default=50,
                   help="histogram bin count (default 50)")
    p.add_argument("--xscale", choices=("lin", "log"), default="lin")
    p.add_argument("--weight", choices=("vol", "num", "int", "surf"),
                   default="vol", help="histogram weighting")
    p.add_argument("--hist", action="append", default=[],
                   metavar="PARAM[=LO:HI][,BINS][,lin|log]"
                           "[,vol|num|int|surf]",
                   help="additional post-fit histogram, repeatable "
                        "(the reference GUI's range list: several "
                        "ranges/weightings per parameter); LO:HI in "
                        "display units, omitted bounds follow the "
                        "active range")
    p.add_argument("--series-stats", action="store_true",
                   help="accumulate series statistics across files")
    p.add_argument("--model-file", action="append", default=[],
                   metavar="PY",
                   help="load user model(s) from a .py file before "
                        "resolving -m (repeatable; reference drop-in "
                        "models, gui/mainwindow.py:95-97)")
    p.add_argument("--model-dir", action="append", default=[],
                   metavar="DIR",
                   help="scan a directory tree for user model files "
                        "(repeatable; reference FindModels startup "
                        "discovery, utils/findmodels.py:73-186)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the fits and the float64 post pass run "
                        "(default cuda: an error without a card; cpu "
                        "runs the kernels' plain PyTorch versions)")
    p.add_argument("--mesh", default=None, metavar="REP[,Q]",
                   help="shard the ensemble over a device mesh of distinct "
                        "--device devices: repetition-axis size and an "
                        "optional q-axis size (e.g. --mesh 2 or --mesh "
                        "2,2; the product must not exceed the visible "
                        "cards, 1 for --device cpu; on the card a q axis "
                        "runs only under use_pallas 'off' in --config)")
    p.add_argument("--prewarm", action="store_true",
                   help="pay the card's first-use costs before the first "
                        "fit: builds (nvcc, the first time for these "
                        "sources) and loads the chunk kernel's library, "
                        "loads the kernel that will run, runs the init "
                        "and the float64 post pass once on dummy data "
                        "(parameter tables are baked with the engine and "
                        "persist in MCSAS_TPU_TABLE_CACHE_DIR): moves "
                        "that time out of the timed analysis; the "
                        "built libraries persist in build/kernels/ for "
                        "later processes")
    p.add_argument("--list-models", action="store_true",
                   help="list available models and exit")
    p.add_argument("-l", "--nolog", action="store_true",
                   help="suppress console logging")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    level = (logging.WARNING if args.nolog
             else logging.DEBUG if args.verbose else logging.INFO)
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")

    from .models import (REGISTRY, get_model, load_model_dir,
                         load_model_file)
    for path in args.model_file:
        load_model_file(path)
    for path in args.model_dir:
        load_model_dir(path)
    if args.list_models:
        for name, m in REGISTRY.items():
            active = ",".join(m.default_active)
            print(f"{name:36s} active=[{active}]  {m.doc}")
        return 0
    if not args.filenames:
        build_parser().error("the following arguments are required: "
                             "filenames")

    cfg = McSASConfig()
    if args.config:
        with open(args.config, "r", encoding="utf-8") as fd:
            raw = json.load(fd)
        if raw and all(isinstance(v, dict) and "default" in v
                       for v in raw.values()):
            cfg = McSASConfig.from_reference_json(args.config)
        else:
            cfg = McSASConfig.from_dict(raw)
    overrides = {}
    if args.contribs is not None:
        overrides["num_contribs"] = args.contribs
    if args.reps is not None:
        overrides["num_reps"] = args.reps
    if args.max_iter is not None:
        overrides["max_iterations"] = int(args.max_iter)
    if args.candidates is not None:
        overrides["candidates_per_step"] = args.candidates
    if args.local_moves is not None:
        overrides["local_moves"] = args.local_moves
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.series_stats:
        overrides["series_stats"] = True
    if overrides:
        cfg = cfg.replace(**overrides)

    model = get_model(args.model)
    active = (tuple(a.strip() for a in args.active.split(","))
              if args.active else None)
    ranges = {}
    for spec in args.range:
        try:
            name, lohi = spec.split("=", 1)
            lo, hi = lohi.split(":")
            unit = model.spec(name).unit
            ranges[name] = (unit.to_si(float(lo)), unit.to_si(float(hi)))
        except (ValueError, KeyError) as e:
            print(f"error: bad --range {spec!r}: {e}", file=sys.stderr)
            return 2
    bound = model.bind(active=active, active_ranges=ranges or None)

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: --device {args.device}: no CUDA device is present "
              f"({e})", file=sys.stderr)
        return 2

    if args.rehistogram:
        return _rehistogram(args)

    data_config = _build_data_config(args)

    from .api import run_files
    from .post.histogram import HistogramSpec
    specs = None
    if (args.bins, args.xscale, args.weight) != (50, "lin", "vol"):
        specs = [HistogramSpec(p, bin_count=args.bins, xscale=args.xscale,
                               yweight=args.weight)
                 for p in bound.active]
    if args.hist:
        try:
            extra = [_parse_hist_spec(h, model, bound.active)
                     for h in args.hist]
        except (ValueError, KeyError) as e:
            print(f"error: bad --hist: {e}", file=sys.stderr)
            return 2
        from .post.histogram import default_histograms
        specs = (list(default_histograms(bound)) if specs is None
                 else specs) + extra
    mesh = None
    if args.mesh:
        try:
            mesh = _build_mesh(args.mesh, args.device)
        except ValueError as e:
            print(f"error: bad --mesh: {e}", file=sys.stderr)
            return 2
    results = run_files(args.filenames, model=bound, cfg=cfg,
                        histograms=specs, data_config=data_config,
                        out_dir=args.outdir, plot=args.plot,
                        device=args.device, mesh=mesh,
                        prewarm=args.prewarm)
    failures = sum(0 if r.converged else 1 for r in results)
    for r in results:
        status = "converged" if r.converged else "NOT CONVERGED"
        print(f"{r.data.title}: chi2={r.engine.conval.round(3).tolist()} "
              f"[{status}], {r.engine.iters_per_sec:,.0f} proposals/s")
    return 1 if failures else 0


def _build_mesh(text: str, device: str):
    """The mesh of a --mesh value REP[,Q] over the distinct devices of
    *device*: every visible card, or the one CPU."""
    import torch
    from .parallel import make_mesh
    dims = [int(x) for x in text.split(",")]
    if len(dims) not in (1, 2) or any(x < 1 for x in dims):
        raise ValueError(f"{text!r}: want REP or REP,Q, each >= 1")
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if device == "cuda" else [torch.device("cpu")])
    return make_mesh((dims[0], dims[1] if len(dims) == 2 else 1), devices)


def _parse_hist_spec(text, model, active):
    """Parses one --hist value: PARAM[=LO:HI][,BINS][,lin|log][,weight]
    (the headless equivalent of one reference range-list row,
    gui/rangelist.py).  One-sided bounds are allowed (``radius=5:``) —
    the omitted side follows the active range."""
    from .post.histogram import HistogramSpec
    head, *opts = text.split(",")
    lower = upper = None
    if "=" in head:
        name, lohi = head.split("=", 1)
        lo, hi = lohi.split(":")
        unit = model.spec(name).unit
        lower = unit.to_si(float(lo)) if lo.strip() else None
        upper = unit.to_si(float(hi)) if hi.strip() else None
    else:
        name = head
        model.spec(name)                     # validate the name
    if name not in active:
        raise ValueError(
            f"{name!r} is not an active (fitted) parameter; histograms "
            f"cover {', '.join(active)}")
    kw = dict(param=name, lower=lower, upper=upper)
    for opt in opts:
        opt = opt.strip()
        if opt in ("lin", "log"):
            kw["xscale"] = opt
        elif opt in ("vol", "num", "int", "surf"):
            kw["yweight"] = opt
        else:
            kw["bin_count"] = int(opt)
    return HistogramSpec(**kw)


def _build_data_config(args):
    """Maps CLI data-settings flags to a DataConfig (None → defaults)."""
    from .data import DataConfig, GaussianSmearing, TrapezoidSmearing
    kw = {}
    if args.qmin is not None:
        kw["x0_low"] = args.qmin * 1e9
    if args.qmax is not None:
        kw["x0_high"] = args.qmax * 1e9
    if args.nbin is not None:
        kw["n_bin"] = args.nbin
    if args.fu_min is not None:
        kw["fu_min"] = args.fu_min
    if args.mask_neg:
        kw["f_mask_neg"] = True
    if args.mask_zero:
        kw["f_mask_zero"] = True
    if args.smear_trapezoid:
        umbra, penumbra = (float(v) for v in
                           args.smear_trapezoid.split(":"))
        kw["smearing"] = TrapezoidSmearing(
            do_smear=True, n_steps=args.smear_steps,
            two_d_coll=args.smear_2d,
            umbra=umbra * 1e9, penumbra=penumbra * 1e9)
    elif args.smear_gaussian is not None:
        kw["smearing"] = GaussianSmearing(
            do_smear=True, n_steps=args.smear_steps,
            two_d_coll=args.smear_2d,
            variance=args.smear_gaussian * 1e9)
    return DataConfig(**kw) if kw else None


def _rehistogram(args) -> int:
    """Re-analysis of stored runs: rebuild histograms from archived
    contributions (the programmatic resume the reference promises for its
    contributions pickle, gui/calc.py:419-426, but never implemented),
    with the float64 post pass on ``--device``."""
    import os

    import numpy as np

    from .api import HIST_HEADER, histogram_columns
    from .io.ascii import write_ascii
    from .io.hdf import load_archive
    from .models import get_model
    from .post.histogram import HistogramSpec, histogram_all
    for fn in args.filenames:
        state = load_archive(fn)
        bound = get_model(state["model"]).bind(
            active=state["active"],
            active_ranges=dict(zip(state["active"], state["ranges"])),
            fixed=state["fixed"])
        contribs = np.transpose(state["contribs"], (2, 0, 1))
        specs = [HistogramSpec(p, bin_count=args.bins, xscale=args.xscale,
                               yweight=args.weight)
                 for p in bound.active]
        _, hists = histogram_all(contribs, state["data"], bound,
                                 state["cfg"], specs, device=args.device)
        outdir = args.outdir or os.path.dirname(fn) or "."
        for h in hists:
            out = os.path.join(
                outdir,
                os.path.basename(fn).replace(".hdf5", "")
                + f"_rehist-{h.spec.param}-{h.spec.bin_count}"
                  f"-{h.spec.xscale}-{h.spec.yweight}.dat")
            write_ascii(out, histogram_columns(h), header=HIST_HEADER)
            print(f"wrote {out}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
