# -*- coding: utf-8 -*-
"""File ingestion: extension-dispatched loaders returning raw column arrays.

Mirrors the reference dispatcher (reference: src/mcsas/datafile/__init__.py:
31-48): ``.pdh`` → PDH reader, ``.h5``/``.hdf5``/``.nxs`` → NXcanSAS,
anything else → tolerant ASCII table reader.
"""
from __future__ import annotations

import os

from .ascii import load_ascii, write_ascii, format_value, FileReadError
from .pdh import load_pdh, write_pdh
from .nxcansas import load_nxcansas, write_nxcansas

FILE_FILTERS = (
    ("All data files", ("csv", "dat", "txt", "pdh", "h5", "hdf5", "nxs")),
    ("ASCII tables", ("csv", "dat", "txt")),
    ("PDH Saxsquant", ("pdh",)),
    ("NXcanSAS", ("h5", "hdf5", "nxs")),
)


def load_raw(filename):
    """Loads a data file into a raw float64 (rows, cols) array plus title."""
    ext = os.path.splitext(str(filename))[1].lower().lstrip(".")
    if ext == "pdh":
        raw = load_pdh(filename)
    elif ext in ("h5", "hdf5", "nxs"):
        raw = load_nxcansas(filename)
    else:
        raw = load_ascii(filename)
    title = os.path.splitext(os.path.basename(str(filename)))[0]
    return raw, title


__all__ = [
    "load_raw", "load_ascii", "load_pdh", "load_nxcansas",
    "write_ascii", "write_pdh", "write_nxcansas", "format_value",
    "FileReadError", "FILE_FILTERS",
]
