"""What a run records for the per-layer readers (``metrics/*.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Step:
    """One call of the timed path: an ``Engine.step`` or a scored window.

    ``prefill``: the true lengths of the prompts (or windows) it ran
    forward in full; ``decode_ctx``: the context of each decode row that
    produced a token; ``launches``: the port's kernel launches
    (``gemv.LAUNCHES`` + ``kv_cache.LAUNCHES``) during the call;
    ``traced``: inside the profiled part of the window."""
    t0: float
    t1: float
    kind: str                  # "admit", "decode" or "score"
    prefill: List[int] = field(default_factory=list)
    decode_ctx: List[int] = field(default_factory=list)
    launches: int = 0
    traced: bool = False
    tokens: int = 0


@dataclass
class Trace:
    """The profiled part of a window, from ``torch.profiler``: its length,
    the union of device activity in it, device seconds by kernel name and
    idle seconds by the host span that was open when each gap began."""
    window_s: float
    busy_s: float
    kernels: Dict[str, float]
    idle: Dict[str, float]


@dataclass
class Run:
    config: dict
    traffic: dict
    kernel_families: Dict[str, List[str]]
    steps: List[Step]
    window: tuple              # (start, end), host clock
    trace: Optional[Trace] = None

    def untraced(self) -> List[Step]:
        return [s for s in self.steps if not s.traced]

    def traced(self) -> List[Step]:
        return [s for s in self.steps if s.traced]

    def untraced_seconds(self) -> float:
        """The length of the window before the profiled part."""
        end = min((s.t0 for s in self.traced()), default=self.window[1])
        return end - self.window[0]

    def family_seconds(self, family: str) -> float:
        """Device seconds of the kernels of ``kernels/<family>.json``."""
        subs = self.kernel_families[family]
        return sum(t for name, t in self.trace.kernels.items()
                   if any(s in name for s in subs))
