"""Host ms of an Engine.step call that admitted one or more requests, mean over
the window before the profiled part (chat traffic)."""
from portbench.metrics._arith import mean_ms


def read(run):
    return mean_ms([s for s in run.untraced() if s.kind == "admit"])
