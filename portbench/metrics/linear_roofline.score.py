"""The quantized linears' share of their roofline while scoring
(metrics/_arith.py)."""
from portbench.metrics._arith import roofline_pct


def read(run):
    return roofline_pct(run)
