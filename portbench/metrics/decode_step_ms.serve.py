"""Host ms of an Engine.step call that admitted nothing (the harness saw no
request pending), mean over the window before the profiled part."""
from portbench.metrics._arith import mean_ms


def read(run):
    return mean_ms([s for s in run.untraced() if s.kind == "decode"])
