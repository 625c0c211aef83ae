"""Share of the profiled window with no operation on the device, while serving."""
from portbench.metrics._arith import idle_pct


def read(run):
    return idle_pct(run)
