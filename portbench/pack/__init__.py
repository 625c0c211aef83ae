"""The program's side of each quantization format: ``pack/<format>.py``
builds the port's quantized leaf of one linear's drawn fields
(``pack(fields, g)``). Only the program's set-up imports these."""
from __future__ import annotations

from types import ModuleType

from ..formats import load_named


def load(name: str) -> ModuleType:
    """The packing module of the quantization format ``name``."""
    return load_named(__name__, name, "quantization format")
