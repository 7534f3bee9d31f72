# -*- coding: utf-8 -*-
"""Documentation drift gate of the PyTorch port (tests/test_docs.py holds
the JAX package's docs): the code blocks of the README's port section,
from its heading ``## PyTorch / H100 port`` to the next ``## ``, must use
names and flags the port has, and the port's examples must parse and
stay off JAX."""
import ast
import importlib
import pathlib
import re
import shlex

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"
_BLOCK = re.compile(r"```(python|bash)\n(.*?)```", re.S)
_HEADING = "## PyTorch / H100 port"
_ALIASES = {"mtt", "mcsas_tpu_torch"}


def _port_section() -> str:
    text = (REPO / "README.md").read_text(encoding="utf-8")
    start = text.index(_HEADING)
    end = text.find("\n## ", start + len(_HEADING))
    return text[start:] if end < 0 else text[start:end]


def _blocks(lang):
    out = [m.group(2) for m in _BLOCK.finditer(_port_section())
           if m.group(1) == lang]
    assert out, f"no {lang} block in the README's port section"
    return out


def _commands():
    """Each command of the section's bash blocks (continuation lines
    joined, comments dropped), as a list of words."""
    out = []
    for code in _blocks("bash"):
        for line in code.replace("\\\n", " ").splitlines():
            words = shlex.split(line, comments=True)
            if words:
                out.append(words)
    return out


def test_port_python_blocks_use_real_names():
    """Every ``mtt.<name>`` resolves on mcsas_tpu_torch, and every ``from
    mcsas_tpu_torch.<mod> import <name>`` on its module."""
    import mcsas_tpu_torch
    for code in _blocks("python"):
        tree = ast.parse(code)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in _ALIASES):
                assert hasattr(mcsas_tpu_torch, node.attr), (
                    f"README: mcsas_tpu_torch.{node.attr} does not exist")
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.split(".")[0] == "mcsas_tpu_torch"):
                mod = importlib.import_module(node.module)
                for a in node.names:
                    assert hasattr(mod, a.name), (
                        f"README: {node.module}.{a.name} does not exist")


def _parser_of(words):
    """The argparse parser a command's flags belong to: the CLI's for
    ``python -m mcsas_tpu_torch`` and ``mcsas-tpu-torch``, a tool's for
    ``python -m mcsas_tpu_torch.tools.<name>`` (None where the command
    is no such call, or the tool builds no parser of its own)."""
    if words[0] == "mcsas-tpu-torch":
        module = "mcsas_tpu_torch.cli"
    elif (len(words) > 2 and words[0].startswith("python")
          and words[1] == "-m"
          and words[2].split(".")[0] == "mcsas_tpu_torch"):
        module = ("mcsas_tpu_torch.cli" if words[2] == "mcsas_tpu_torch"
                  else words[2])
    else:
        return None
    build = getattr(importlib.import_module(module), "build_parser", None)
    return build() if build else None


def test_port_bash_flags_exist():
    """Every long flag of a port command in the section's bash blocks is
    an option of that command's parser."""
    checked = 0
    for words in _commands():
        parser = _parser_of(words)
        if parser is None:
            continue
        known = {s for a in parser._actions for s in a.option_strings}
        for word in words[1:]:
            flag = word.split("=", 1)[0]
            if re.fullmatch(r"--[a-z][a-z0-9-]*", flag):
                assert flag in known, (
                    f"README: {' '.join(words)}: unknown flag {flag}")
        checked += 1
    assert checked >= 4


def test_port_bash_examples_exist():
    """Every ``examples/torch/<name>.py`` a bash block runs exists."""
    runs = [w for words in _commands() for w in words
            if w.startswith("examples/torch/")]
    assert runs
    for path in runs:
        assert (REPO / path).is_file(), f"README: {path} does not exist"


def _examples():
    files = sorted(EXAMPLES.glob("*.py"))
    assert {f.name for f in files} >= {
        "quickstart.py", "smeared_fit.py", "anisotropic2d.py",
        "multichip.py"}
    return files


@pytest.mark.parametrize("path", _examples(), ids=lambda p: p.name)
def test_examples_parse_and_import_no_jax(path):
    """Each example parses, imports neither ``jax`` nor ``mcsas_tpu`` (an
    AST walk of its imports, nested ones included), and imports the
    port."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "mcsas_tpu"}, sorted(roots)
    assert "mcsas_tpu_torch" in roots
