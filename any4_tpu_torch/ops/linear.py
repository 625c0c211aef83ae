"""Quantized tensor container and the ``linear`` dispatch (counterpart of
``any4_tpu/ops/linear.py``).

A quantized weight is a :class:`QuantizedTensor` leaf in the parameter
tree, and :func:`linear` dispatches on the leaf type: dense weights go to a
plain matmul, quantized ones to the fused kernels of :mod:`.gemv`.

Formats of this slice: ``any4`` (learned per-row LUT), ``nf4`` and ``fp4``
(global tables), and their ``t`` names (``any4t``, ``nf4t``, ``fp4t``). As in
the JAX package, ``any4``/``nf4``/``fp4`` are renamed to the ``t`` formats
when ``group_size % 128 == 0`` unless ``layout="row"``; the name records
which TPU layout a weight came from or goes back to. In the port both names
share one Hopper layout (:mod:`.packing`), and the group size alone picks
the kernel: kernel A (``q4_lut_post``) at ``g % 128 == 0``, kernel B
(``q4_lut_fused``) below.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import gemv, packing, quant
from .formats import get_table

# Largest m run as one fused call; larger m is chunked through the kernel
# in tiles of this many rows. The value 512 was measured on the TPU for the
# Pallas kernels; it is kept as a parameter and is not a Hopper measurement.
FUSED_M_MAX = 512

LUT_FMTS = ("any4", "any4t", "nf4", "nf4t", "fp4", "fp4t")


@dataclass
class QuantizedTensor:
    """A quantized 2-D weight ``[n, k]`` in the port's Hopper layout.

    Fields:
      packed: ``[n, kp/8] int32`` codes, 8 consecutive k per word
              (:func:`~.packing.pack_codes`), ``kp = padded_k(k)``.
      scales: ``[kp/g, n] f32`` group scales (the JAX package's layout).
      zeros:  ``[kp/g, n] f32`` group zeros (0 for the absmax formats).
      lut:    ``[n, 16]`` per-row or ``[1, 16]`` global f32 table, centered
              (any4 stores ``lut - 8``). Always row-oriented here, whatever
              the format name; the JAX package keeps ``any4t``'s as
              ``[16, n]``.
    Reconstruction: ``lut[row, code] * scale + zero``.
    """
    packed: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    lut: Optional[torch.Tensor]
    fmt: str = "any4t"
    group_size: int = 128
    shape: tuple = ()
    dtype: torch.dtype = torch.bfloat16
    row_shards: int = 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.scales, self.zeros, self.lut)
                   if t is not None)


def _check_fmt(fmt: str) -> None:
    if fmt not in LUT_FMTS:
        raise NotImplementedError(
            f"format {fmt!r} is not ported yet (ROADMAP queue 1, item 8)")


def quantize_tensor(w: torch.Tensor, fmt: str = "any4", group_size: int = 128,
                    row_shards: int = 1, **kwargs) -> QuantizedTensor:
    """Quantize a 2-D weight ``[n, k]`` on its own device.

    ``kwargs`` go to the any4 learner for the any4 formats (sample_weight,
    init, kmeans_iters, keep_outliers, ...); ``layout="row"`` keeps the
    ``any4``/``nf4``/``fp4`` name at ``g % 128 == 0``.
    """
    from ..quant import anyq  # anyq imports this package's ops

    layout = kwargs.pop("layout", None)
    if layout not in (None, "row", "transposed"):
        raise ValueError(f"layout must be None/'row'/'transposed', got "
                         f"{layout!r}")
    if row_shards != 1:
        raise NotImplementedError(
            "row_shards != 1 (row-parallel packing) is not ported yet "
            "(ROADMAP queue 1, item 12)")
    _check_fmt(fmt)
    n, k = w.shape
    if group_size <= 0 or group_size > k:
        group_size = k      # whole-row grouping for a layer narrower than g
    base = fmt.rstrip("t")
    symmetric = bool(kwargs.pop("scale_only", False))
    if symmetric and base != "any4":
        raise ValueError(f"scale_only applies to any4, not {fmt!r}")
    if group_size % 128 == 0 and (fmt.endswith("t") or layout != "row"):
        fmt = base + "t"
    else:
        fmt = base          # sub-128 groups have no transposed TPU layout
    if base == "any4":
        codes, lut01, scales, zeros = anyq.any4_quantize(
            w, n_bit=4, group_size=group_size, scale_only=symmetric, **kwargs)
        lut = (lut01 - 8.0).float()                    # centered storage
    else:
        codes, scales = quant.lut_quantize(w, base, group_size)
        zeros = torch.zeros_like(scales)
        lut = torch.as_tensor(get_table(base), device=w.device)[None, :]
    scales = packing.pad_groups(scales, k, group_size)
    zeros = packing.pad_groups(zeros, k, group_size)
    return QuantizedTensor(packing.pack_codes(codes), scales.t().contiguous(),
                           zeros.t().contiguous(), lut.contiguous(), fmt,
                           group_size, (n, k), w.dtype, 1)


def dequantize_tensor(qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """Reconstruct the dense weight ``[n, k]``: ``lut[code] * s + z`` in f32
    (a multiply, then an add), cast to ``dtype`` (default: the weight's)."""
    n, k = qt.shape
    kp = qt.packed.shape[1] * packing.CODES_PER_WORD
    codes = packing.unpack_codes(qt.packed, kp).long()
    q = torch.gather(qt.lut.float().expand(n, 16), 1, codes)
    g = qt.group_size
    scales = torch.repeat_interleave(qt.scales.t(), g, dim=1)[:, :kp]
    zeros = torch.repeat_interleave(qt.zeros.t(), g, dim=1)[:, :kp]
    w = q[:, :scales.shape[1]] * scales + zeros
    return w[:, :k].to(dtype or qt.dtype)


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
           fused_m_max: int = FUSED_M_MAX) -> torch.Tensor:
    """``y = x @ W^T + bias`` where ``w`` is dense ``[n, k]`` or a
    :class:`QuantizedTensor`.

    Quantized weights run the fused kernel for ``m <= fused_m_max`` rows of
    ``x`` in one call, larger ``m`` in chunks of ``fused_m_max`` rows, and
    ``fused_m_max=0`` dequantizes and runs a plain matmul.
    """
    if not isinstance(w, QuantizedTensor):
        y = torch.matmul(x, w.to(x.dtype).t())
    elif fused_m_max > 0:
        m = x.numel() // x.shape[-1]

        def mm(xc):
            return gemv.quantized_matmul(xc, w.packed, w.scales, w.zeros,
                                         w.lut, group_size=w.group_size,
                                         out_dtype=x.dtype)

        if m <= fused_m_max:
            y = mm(x)
        else:
            x2 = x.reshape(m, x.shape[-1])
            y = torch.cat([mm(x2[i:i + fused_m_max])
                           for i in range(0, m, fused_m_max)])
            y = y.reshape(*x.shape[:-1], w.shape[0])
    else:
        y = torch.matmul(x, dequantize_tensor(w, dtype=x.dtype).t())
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
