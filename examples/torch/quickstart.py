# -*- coding: utf-8 -*-
"""Headless equivalent of the reference's GUI quickstart
(reference: doc/source/quickstart.rst) on the PyTorch/CUDA port: fit the
3-population sphere mix in quickstartdemo1.csv on the card (the chunks
run in the CUDA kernel K1) with a log-scaled post-fit histogram, and
write the full output file set (and a plot where matplotlib is
installed).

    python examples/torch/quickstart.py [path/to/quickstartdemo1.csv]
"""
import importlib.util
import pathlib
import sys
import time

import mcsas_tpu_torch as mtt

DATA = (pathlib.Path(__file__).resolve().parents[2] / "testdata"
        / "quickstartdemo1.csv")


def main(path):
    data = mtt.load(path)
    print(f"loaded {data.title}: {data.count} fit points, "
          f"sphere-size estimate "
          f"{tuple(round(x * 1e9, 2) for x in data.spherical_size_estimate)}"
          f" nm")

    # "copy the sphere size estimates to the model" (quickstart step 2)
    bound = mtt.get_model("Sphere").bind(
        active_ranges={"radius": data.spherical_size_estimate})

    # reference defaults: 300 contributions x 10 repetitions; the iteration
    # budget is larger here because each repetition runs to chi2<=1 in one
    # attempt instead of relying on retries
    cfg = mtt.McSASConfig(num_contribs=300, num_reps=10,
                          max_iterations=2_000_000, candidates_per_step=64,
                          chunk_steps=2048)

    # log-scaled histogram (quickstart step 3)
    hist = [mtt.HistogramSpec("radius", xscale="log", bin_count=50)]

    t0 = time.perf_counter()
    result = mtt.fit(data, model=bound, cfg=cfg, histograms=hist,
                     device="cuda")
    print(f"optimization took {time.perf_counter() - t0:.2f} s on the card "
          f"(reference quickstart: 36 s on a 2012 iMac), K1 ran: "
          f"{result.engine.used_pallas}; "
          f"chi2 = {result.engine.conval.round(3).tolist()}")

    plot = importlib.util.find_spec("matplotlib") is not None
    files = mtt.OutputFiles(result, out_dir=".").write_all(plot=plot)
    print("wrote:", ", ".join(str(v) for v in files.values()))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DATA)
