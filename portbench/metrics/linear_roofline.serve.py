"""The quantized linears' share of their roofline while serving
(metrics/_arith.py)."""
from portbench.metrics._arith import roofline_pct


def read(run):
    return roofline_pct(run)
