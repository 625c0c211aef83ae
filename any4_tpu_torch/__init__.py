"""any4 for PyTorch on NVIDIA Hopper: a port of the ``any4_tpu`` package.

The module tree mirrors ``any4_tpu`` (``ops/``, ``quant/``, ``models/``) so
each function has a counterpart of the same name there. Parameter trees are
plain dicts and lists of tensors, as the JAX package's pytrees are; a
quantized weight is an :class:`~any4_tpu_torch.ops.linear.QuantizedTensor`.

The fused 4-bit LUT matmuls are CUDA kernels written for ``sm_90a``
(``ops/csrc/``), compiled with ``nvcc`` at first use into ``_build/`` and
loaded with ctypes (:mod:`any4_tpu_torch.ops.build`). Importing the package
needs only torch and numpy: nothing is compiled and no device is touched
until a kernel is first launched.

Entry points (``init_params``, ``quantize_model``, ``generate``,
``load_params``) run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper computes its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
