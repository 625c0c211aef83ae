"""The served model's flops over the window, as a share of the bf16 peak
(metrics/_arith.py)."""
from portbench.metrics._arith import mfu_pct


def read(run):
    return mfu_pct(run)
