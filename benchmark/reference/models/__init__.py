"""One module per model, named as the model is: ``ff``, ``volume``,
``absvolume``, ``DEFAULTS`` and ``engine_params``."""
import importlib
import pathlib
import re

_DIR = pathlib.Path(__file__).resolve().parent


def get(name: str):
    """The reference module of model *name* (``models/<name>.py``)."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not (
            _DIR / f"{name}.py").is_file():
        raise KeyError(f"no reference model {name!r} under {_DIR}")
    return importlib.import_module(f"{__name__}.{name}")
