"""Numeric core, packing, the CUDA kernels and the ``linear`` dispatch."""
