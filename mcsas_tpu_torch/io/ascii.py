# -*- coding: utf-8 -*-
"""Tolerant ASCII / CSV column readers for SAS data files.

Behavioral parity with the reference parser (reference:
src/mcsas/datafile/asciifile.py:99-143) which accepts a wide range of
dialects: comma / semicolon / tab / whitespace delimiters, decimal commas,
header and footer lines, interspersed empty lines, leading/trailing spaces,
unicode headers, CR-only line endings, and extra columns.  The strategy:

* decode utf-8, falling back to latin-1,
* split on any of \\n, \\r\\n, \\r,
* per line: if the line contains a '.', commas are treated as field
  separators; otherwise commas are decimal separators and converted to '.',
  then semicolons become separators and the line is whitespace-split,
* lines that fail float conversion before any data was found are skipped
  (headers); after data started, the first incompatible line (parse failure
  or different column count) terminates the record list (footers).
"""
from __future__ import annotations

import os

import numpy as np


class FileReadError(IOError):
    pass


def _decode(raw: bytes) -> str:
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError:
        return raw.decode("latin-1")


def read_text_lines(filename) -> list:
    with open(filename, "rb") as fd:
        return _decode(fd.read()).splitlines()


def parse_line(line: str):
    """Returns a tuple of floats for a data line, or None if unparseable."""
    if "." in line:
        line = line.replace(",", " ")
    else:  # decimal-comma dialect (no points anywhere in the line)
        line = line.replace(",", ".")
    fields = line.strip().replace(";", " ").split()
    if not fields:
        return None
    try:
        return tuple(float(f) for f in fields)
    except ValueError:
        return None


def read_array(lines, start_line: int = 0, end_line=None,
               filename: str = "<data>") -> np.ndarray:
    """Extracts one homogeneous float array from a window of text lines.

    Skips any prefix of non-numeric lines, collects consecutive rows with a
    consistent column count, and stops at the first incompatible line after
    data has begun.
    """
    records = []
    for line in lines[start_line:end_line]:
        if not line.strip():
            continue      # blank lines never terminate a table
        rec = parse_line(line)
        if rec is None:
            if not records:
                continue  # still searching for the first data line
            break         # footer: data listing ends here
        if records and len(records[0]) != len(rec):
            break         # column count changed: end of table
        records.append(rec)
    if not records:
        raise FileReadError(f"No data columns found in {filename!r}")
    return np.array(records, dtype=np.float64)


def load_ascii(filename, skip_lines: int = 0,
               use_native: bool = None) -> np.ndarray:
    """Reads a raw (rows, cols) float64 array from an ASCII file.

    Uses the C++ tokenizer (``io/native.py``, built at first use; a build
    that fails raises) unless *use_native* is False or, by default,
    MCSAS_TPU_NO_NATIVE=1 asks for the pure-Python parser.  A text in which
    the tokenizer finds no table goes to the Python parser, which raises
    FileReadError as before.
    """
    if use_native is None:
        use_native = os.environ.get("MCSAS_TPU_NO_NATIVE", "") != "1"
    with open(filename, "rb") as fd:
        raw = fd.read()
    text = _decode(raw)
    if use_native:
        from . import native
        arr = native.parse_text(text, skip_lines)
        if arr is not None:
            return arr
    return read_array(text.splitlines(), start_line=skip_lines,
                      filename=str(filename))


# ---------------------------------------------------------------- writing

VALUE_FORMAT = "{0: 14.6E}"  # same numeric formatting as the reference writer


def format_value(value) -> str:
    try:
        return VALUE_FORMAT.format(value)
    except (ValueError, TypeError):
        return "{0}".format(value)


def format_data(data, separator: str = " ") -> str:
    return "\n".join(separator.join(format_value(v) for v in row)
                     for row in np.atleast_2d(data))


def write_ascii(filename, data, header=None, append: bool = False):
    """Writes a numeric table; optional single header line (string or
    sequence of column names)."""
    mode = "a" if append else "w"
    with open(filename, mode, encoding="utf-8") as fd:
        if header is not None:
            if not isinstance(header, str):
                header = " ".join(header)
            fd.write(header + "\n")
        fd.write(format_data(data) + "\n")
