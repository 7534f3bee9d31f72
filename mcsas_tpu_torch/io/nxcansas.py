# -*- coding: utf-8 -*-
"""NXcanSAS (NeXus HDF5) reader.

The reference ships a broken experimental reader (reference:
src/mcsas/datafile/nxcansasfile.py:11-66 — missing imports, h5py API typos);
this is a working implementation of the same capability: locate an
``SASentry/SASdata`` group by NX_class/canSAS_class attributes or fall back
to conventional paths, and extract Q / I / Idev columns with their units.
"""
from __future__ import annotations

import numpy as np

try:
    import h5py
    _HAVE_H5PY = True
except ImportError:  # pragma: no cover - h5py is expected in the image
    h5py = None
    _HAVE_H5PY = False


def _attr(obj, name, default=""):
    v = obj.attrs.get(name, default)
    if isinstance(v, bytes):
        v = v.decode("utf-8", "replace")
    return v


def _find_sasdata(h5):
    """Returns the first group marked as canSAS/NeXus SASdata."""
    found = []

    def visitor(name, obj):
        if isinstance(obj, h5py.Group):
            cls = _attr(obj, "canSAS_class") or _attr(obj, "NX_class")
            if cls in ("SASdata", "NXdata") and "Q" in obj and "I" in obj:
                found.append(obj)

    h5.visititems(visitor)
    if found:
        return found[0]
    # conventional fallback paths
    for path in ("sasentry01/sasdata01", "entry/sasdata", "sasentry/sasdata"):
        if path in h5 and "Q" in h5[path]:
            return h5[path]
    raise IOError("no SASdata group with Q and I found")


_Q_UNIT_TO_SI = {"1/m": 1.0, "m^-1": 1.0, "1/nm": 1e9, "nm^-1": 1e9,
                 "1/A": 1e10, "A^-1": 1e10, "1/angstrom": 1e10}
_I_UNIT_TO_SI = {"1/(m sr)": 1.0, "1/(cm sr)": 1e2, "1/cm": 1e2, "1/m": 1.0,
                 "arbitrary": 1.0, "a.u.": 1.0}


def load_nxcansas(filename) -> np.ndarray:
    """Returns a raw (n, 3) array of q[nm⁻¹], I[(m sr)⁻¹], σI columns.

    Values are converted back to the nm⁻¹ / (m sr)⁻¹ raw-file convention so
    the downstream pipeline treats all loaders identically.
    """
    if not _HAVE_H5PY:
        raise ImportError("h5py is required for NXcanSAS files")
    with h5py.File(filename, "r") as h5:
        grp = _find_sasdata(h5)
        q = np.asarray(grp["Q"], dtype=np.float64).ravel()
        i = np.asarray(grp["I"], dtype=np.float64).ravel()
        qf = _Q_UNIT_TO_SI.get(_attr(grp["Q"], "units", "1/m"), 1.0)
        if_ = _I_UNIT_TO_SI.get(_attr(grp["I"], "units", "1/(m sr)"), 1.0)
        q = q * qf / 1e9          # SI → nm⁻¹ raw convention
        i = i * if_
        if "Idev" in grp:
            u = np.asarray(grp["Idev"], dtype=np.float64).ravel() * if_
        else:
            u = np.zeros_like(i)
        return np.column_stack([q, i, u])


def write_nxcansas(filename, q_nm, intensity, uncertainty=None,
                   title: str = "mcsas_tpu"):
    """Writes a minimal valid NXcanSAS file (inverse of load_nxcansas)."""
    if not _HAVE_H5PY:
        raise ImportError("h5py is required for NXcanSAS files")
    with h5py.File(filename, "w") as h5:
        entry = h5.create_group("sasentry01")
        entry.attrs["NX_class"] = "NXentry"
        entry.attrs["canSAS_class"] = "SASentry"
        entry["title"] = title
        data = entry.create_group("sasdata01")
        data.attrs["NX_class"] = "NXdata"
        data.attrs["canSAS_class"] = "SASdata"
        data.attrs["signal"] = "I"
        data.attrs["I_axes"] = "Q"
        dq = data.create_dataset("Q", data=np.asarray(q_nm, dtype=np.float64))
        dq.attrs["units"] = "1/nm"
        di = data.create_dataset("I", data=np.asarray(intensity, np.float64))
        di.attrs["units"] = "1/(m sr)"
        if uncertainty is not None:
            du = data.create_dataset(
                "Idev", data=np.asarray(uncertainty, np.float64))
            du.attrs["units"] = "1/(m sr)"
            di.attrs["uncertainties"] = "Idev"
