# -*- coding: utf-8 -*-
"""HDF5 state archive: full dump of a fit (data, config, model binding,
engine results, histograms) plus a real load path.

The reference writes a comparable archive through its hdfWrite visitor
(src/mcsas/utils/hdf.py:88-229, invoked at gui/calc.py:302-309) but its
``hdfLoad`` is an unimplemented stub (utils/hdf.py:225-229); here the
archive round-trips: :func:`load_archive` restores the contribution set,
config and data so an analysis can be resumed / re-histogrammed.

The layout and the format tag are the JAX package's (mcsas_tpu/io/hdf.py),
so an archive written by either package loads in the other.  h5py is an
optional dependency: it is imported when an archive is written or read,
and its absence raises ImportError there.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

ROOT = "mcsasentry"
FORMAT = "mcsas_tpu-archive-v1"


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("h5py is required for HDF5 archives") from exc
    return h5py


def write_archive(filename, result, root: str = ROOT) -> str:
    """Writes a complete fit state archive."""
    h5py = _h5py()
    with h5py.File(filename, "w") as h5:
        g = h5.create_group(root)
        g.attrs["format"] = FORMAT

        d = g.create_group("data")
        d.attrs["title"] = result.data.title or ""
        d.attrs["filename"] = str(result.data.filename)
        d.create_dataset("raw", data=result.data.raw)
        d.create_dataset("q", data=result.data.q)
        d.create_dataset("f", data=result.data.f)
        d.create_dataset("fu", data=result.data.fu)
        d.create_dataset("valid", data=result.data.valid)
        dc = {k: v for k, v in
              vars_of_dataclass(result.data.config).items()
              if k != "smearing"}
        d.attrs["config"] = json.dumps(dc)
        sm = result.data.config.smearing
        if sm is not None:
            d.attrs["smearing_type"] = type(sm).__name__
            d.attrs["smearing"] = json.dumps(vars_of_dataclass(sm))

        g.attrs["algorithm_config"] = result.cfg.to_json()

        m = g.create_group("model")
        m.attrs["name"] = result.bound.model.name
        m.attrs["active"] = json.dumps(list(result.bound.active))
        m.attrs["ranges"] = json.dumps(
            [list(r) for r in result.bound.ranges])
        m.attrs["fixed"] = json.dumps(
            {k: v for k, v in result.bound.fixed})

        e = g.create_group("result")
        e.create_dataset("contribs", data=result.contribs)
        for name in ("conval", "n_iter", "n_moves", "converged",
                     "scaling", "background", "measval"):
            e.create_dataset(name, data=getattr(result.engine, name))
        e.attrs["elapsed"] = result.engine.elapsed

        hh = g.create_group("histograms")
        for i, h in enumerate(result.histograms):
            hg = hh.create_group(f"hist{i:02d}")
            hg.attrs["spec"] = json.dumps(vars_of_dataclass(h.spec))
            hg.create_dataset("xLowerEdge", data=h.x_lower_edge)
            hg.create_dataset("xMean", data=h.x_mean)
            hg.create_dataset("xWidth", data=h.x_width)
            hg.create_dataset("bins", data=h.bins.full)
            hg.create_dataset("cdf", data=h.cdf.full)
            hg.create_dataset("observability", data=h.observability)
            hg.attrs["moments"] = json.dumps(list(h.moments.fields))
    return str(filename)


def vars_of_dataclass(obj) -> dict:
    """The JSON-representable fields of a dataclass (tuples as lists)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (int, float, str, bool)) or v is None:
            out[f.name] = v
        elif isinstance(v, tuple):
            out[f.name] = list(v)
    return out


def load_archive(filename, root: str = ROOT) -> dict:
    """Restores the stored state: enough to re-histogram or re-plot.

    Returns a dict with 'contribs' ((N, P, R) reference layout), 'data'
    (rebuilt SASData), 'cfg' (McSASConfig), 'model'/'active'/'ranges'/
    'fixed' and the stored result arrays.
    """
    h5py = _h5py()
    from ..config import McSASConfig
    from ..data import (DataConfig, GaussianSmearing, TrapezoidSmearing,
                        from_raw)
    with h5py.File(filename, "r") as h5:
        g = h5[root]
        d = g["data"]
        cfg_kwargs = json.loads(d.attrs["config"])
        cfg_kwargs.pop("value_range", None)
        smearing = None
        if "smearing_type" in d.attrs:
            cls = {"TrapezoidSmearing": TrapezoidSmearing,
                   "GaussianSmearing": GaussianSmearing}[
                       d.attrs["smearing_type"]]
            smearing = cls(**json.loads(d.attrs["smearing"]))
        dconfig = DataConfig(smearing=smearing, **cfg_kwargs)
        data = from_raw(np.asarray(d["raw"]), title=d.attrs["title"],
                        filename=d.attrs["filename"], config=dconfig)
        out = dict(
            data=data,
            cfg=McSASConfig.from_json(g.attrs["algorithm_config"]),
            model=g["model"].attrs["name"],
            active=tuple(json.loads(g["model"].attrs["active"])),
            ranges=[tuple(r) for r in
                    json.loads(g["model"].attrs["ranges"])],
            fixed=json.loads(g["model"].attrs["fixed"]),
            contribs=np.asarray(g["result/contribs"]),
        )
        for name in ("conval", "scaling", "background", "measval"):
            out[name] = np.asarray(g[f"result/{name}"])
        return out
