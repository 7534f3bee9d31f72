# -*- coding: utf-8 -*-
"""PDH (Anton-Paar SAXSquant) format reader/writer.

The PDH layout has a fixed 5-line header (description, keywords, counts,
instrument floats, spare line) followed by whitespace-separated numeric
columns (reference: src/mcsas/datafile/pdhfile.py:8-107).
"""
from __future__ import annotations

import numpy as np

from .ascii import read_text_lines, read_array, format_data

PDH_HEADER_LINES = 5


def load_pdh(filename) -> np.ndarray:
    lines = read_text_lines(filename)
    return read_array(lines, start_line=PDH_HEADER_LINES,
                      filename=str(filename))


def _header_lines(n_rows: int, description: str = "") -> list:
    counts = [int(n_rows)] + [0] * 7
    floats1 = [0.0] * 5   # sample-detector distance, norm factor, wavelength…
    floats2 = [0.0] * 5
    return [
        "{0}".format(description),
        "SAXS BOX",
        " ".join("{0: 9d}".format(v) for v in counts),
        " ".join("{0: 14.6E}".format(v) for v in floats1),
        " ".join("{0: 14.6E}".format(v) for v in floats2),
    ]


def write_pdh(filename, data, description: str = ""):
    data = np.atleast_2d(np.asarray(data))
    with open(filename, "w", encoding="utf-8") as fd:
        fd.write("\n".join(_header_lines(data.shape[0], description)) + "\n")
        fd.write(format_data(data) + "\n")
