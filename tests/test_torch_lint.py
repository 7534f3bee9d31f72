# -*- coding: utf-8 -*-
"""Lint gate of the PyTorch port (tests/test_lint.py holds the JAX
package's): the in-repo checker tools/lint.py must be clean over the
port's package, its chip smoke script and its examples."""
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))


@pytest.mark.parametrize("path", ["mcsas_tpu_torch", "chip_smoke.py",
                                  "examples/torch"])
def test_port_lint_clean(path):
    import lint
    findings = lint.lint_paths([str(REPO / path)])
    msg = "\n".join(f"{p}:{ln}: {code} {m}" for p, ln, code, m in findings)
    assert not findings, f"lint findings:\n{msg}"
