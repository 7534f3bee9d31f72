# -*- coding: utf-8 -*-
"""Logging subsystem: ISO-8601 timestamps, per-run log files, and
stdout/stderr capture into logging.

Reference: src/mcsas/log/log.py:13-78 (formatter + handler swaps),
log/sink.py:13-38 (stream redirection), and the per-run timestamped log
file at gui/calc.py:283-288.
"""
from __future__ import annotations

import datetime
import logging
import sys

LOG_FORMAT = "%(asctime)s %(levelname)-8s %(name)s: %(message)s"
DATE_FORMAT = "%Y-%m-%d %H:%M:%S"


def timestamp() -> datetime.datetime:
    return datetime.datetime.now()


def timestamp_formatted(ts: datetime.datetime = None) -> str:
    """File-name-safe ISO-ish timestamp (reference log.timestampFormatted)."""
    return (ts or timestamp()).strftime("%Y-%m-%d_%H-%M-%S")


def make_formatter() -> logging.Formatter:
    return logging.Formatter(LOG_FORMAT, datefmt=DATE_FORMAT)


def basic_setup(level=logging.INFO):
    """Console logging with the standard format (idempotent)."""
    root = logging.getLogger()
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(make_formatter())
        root.addHandler(h)
    root.setLevel(level)


class RunLogFile:
    """Context manager adding a per-run log file handler
    (reference: gui/calc.py:283-288)."""

    def __init__(self, path, level=logging.INFO):
        self.path = str(path)
        self.level = level
        self._handler = None

    def __enter__(self):
        self._handler = logging.FileHandler(self.path, encoding="utf-8")
        self._handler.setFormatter(make_formatter())
        self._handler.setLevel(self.level)
        logging.getLogger().addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        if self._handler is not None:
            logging.getLogger().removeHandler(self._handler)
            self._handler.close()
        return False


class Sink:
    """File-like object forwarding writes into a logger — used to capture
    stdout/stderr of third-party code (reference: log/sink.py:13-38)."""

    def __init__(self, logger=None, level=logging.INFO):
        self.logger = logger or logging.getLogger("stdout")
        self.level = level
        self._buffer = ""

    def write(self, text):
        self._buffer += text
        while "\n" in self._buffer:
            line, self._buffer = self._buffer.split("\n", 1)
            if line.strip():
                self.logger.log(self.level, line)

    def flush(self):
        if self._buffer.strip():
            self.logger.log(self.level, self._buffer)
        self._buffer = ""

    def isatty(self):
        return False


class CaptureStreams:
    """Redirects stdout/stderr into logging for the scope
    (reference replaceStdOutErr)."""

    def __init__(self):
        self._saved = None

    def __enter__(self):
        self._saved = (sys.stdout, sys.stderr)
        sys.stdout = Sink(logging.getLogger("stdout"), logging.INFO)
        sys.stderr = Sink(logging.getLogger("stderr"), logging.WARNING)
        return self

    def __exit__(self, *exc):
        sys.stdout, sys.stderr = self._saved
        return False
