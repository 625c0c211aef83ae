"""The timed paths, one module a traffic ``kind``: ``drivers/<kind>.py``,
whose ``run(cell, seed, seconds, trace, device, t_start, control)`` sets
the cell up, runs its window and judges a sample of what the window made,
returning ``(info, checks)``. A new kind of traffic is a new file."""
from __future__ import annotations

from types import ModuleType

from ..formats import load_named


def load(kind: str) -> ModuleType:
    """The driver of the traffic kind ``kind``."""
    return load_named(__name__, kind, "traffic kind")
