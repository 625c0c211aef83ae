"""Quantization formats, one module a format: ``formats/<format>.py``,
found by the ``format`` of a configuration's ``quantization``. Each draws
a layer's fields from a generator (``draw``) and dequantizes one linear's
fields in float32 (``dequantize``), in plain PyTorch: the reference reads
these modules. The program's packing of the same fields is
``pack/<format>.py``. A new format is two new files."""
from __future__ import annotations

import importlib
import re
from types import ModuleType


def load_named(package: str, name: str, what: str) -> ModuleType:
    """``<package>.<name>``, or ``ValueError`` when there is no such
    file."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"{what} {name!r} is not a module name")
    full = f"{package}.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ValueError(f"no {what} {name!r} ({full})") from e


def load(name: str) -> ModuleType:
    """The module of the quantization format ``name``."""
    return load_named(__name__, name, "quantization format")
