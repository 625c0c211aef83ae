"""Quantized tensor container and the ``linear`` dispatch (counterpart of
``any4_tpu/ops/linear.py``).

A quantized weight is a :class:`QuantizedTensor` leaf in the parameter
tree, and :func:`linear` dispatches on the leaf type: dense weights go to a
plain matmul, quantized ones to the fused kernels of :mod:`.gemv`.

Formats ported so far:

- ``any4`` (learned per-row LUT), ``nf4`` and ``fp4`` (global tables), and
  their ``t`` names (``any4t``, ``nf4t``, ``fp4t``); as in the JAX package,
  ``any4``/``nf4``/``fp4`` are renamed to the ``t`` formats when
  ``group_size % 128 == 0`` unless ``layout="row"``;
- ``int4`` (uniform, no LUT), renamed to ``int4p`` when ``g % 128 == 0``,
  ``n`` is even and the layout is not ``"row"``;
- ``w4a8``: int4 weights with activations quantized per row to int8.

The name records which TPU layout a weight came from or goes back to; in
the port every name shares one Hopper layout (:mod:`.packing`). The
kernels, by :func:`_kernel_fmt` and :func:`.gemv.quantized_matmul`: kernel
A for the ``t`` formats and the row LUT formats at ``g % 128 == 0``,
kernel B below that and for row-layout ``int4`` at every g, kernel C for
``int4p``, kernels D/D-fused for ``w4a8``, kernel E for the row-layout
formats with ``use_gather=False``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import gemv, packing, quant
from .formats import get_table
from .quant import quantize_activations

# Largest m run as one fused call; larger m is chunked through the kernel
# in tiles of this many rows. The value 512 was measured on the TPU for the
# Pallas kernels; it is kept as a parameter and is not a Hopper measurement.
FUSED_M_MAX = 512
# m-chunk of the w4a8 kernel above FUSED_ACT_M_MAX rows: the TPU's VMEM
# budget for int8 activations and an f32 accumulator (1024 rows at
# k <= 4096, else 512). Kept so that routing and launch counts match the
# JAX package; not a Hopper measurement.
_INT8_M_TILE = 512


def _int8_m_tile(k: int) -> int:
    return 1024 if k <= 4096 else _INT8_M_TILE


LUT_FMTS = ("any4", "any4t", "nf4", "nf4t", "fp4", "fp4t")
INT_FMTS = ("int4", "int4p", "w4a8")
FMTS = LUT_FMTS + INT_FMTS


@dataclass
class QuantizedTensor:
    """A quantized 2-D weight ``[n, k]`` in the port's Hopper layout.

    Fields:
      packed: ``[n, kp/8] int32`` codes, 8 consecutive k per word
              (:func:`~.packing.pack_codes`), ``kp = padded_k(k)``.
      scales: ``[kp/g, n] f32`` group scales (the JAX package's layout).
      zeros:  ``[kp/g, n] f32`` group zeros (0 for the absmax formats).
      lut:    ``[n, 16]`` per-row or ``[1, 16]`` global f32 table, centered
              (any4 stores ``lut - 8``), or None for the integer formats.
              Always row-oriented here, whatever the format name; the JAX
              package keeps ``any4t``'s as ``[16, n]``.
    Reconstruction: ``lut[row, code] * scale + zero``, ``(code - 8) * scale
    + zero`` without a LUT.
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
    if fmt not in FMTS:
        raise NotImplementedError(
            f"format {fmt!r} is not ported yet (ROADMAP queue 1, item 8)")


def _kernel_fmt(fmt: str, lut: Optional[torch.Tensor] = None) -> str:
    """The kernel format of a weight format, as the JAX package names it:
    ``lut4``/``lut4t`` for a global table, the format itself otherwise."""
    if fmt in ("nf4", "fp4") or (fmt == "any4" and lut is not None
                                 and lut.shape[0] == 1):
        return "lut4"
    if fmt in ("nf4t", "fp4t") or (fmt == "any4t" and lut is not None
                                   and lut.shape[0] == 1):
        return "lut4t"
    return fmt


def quantize_tensor(w: torch.Tensor, fmt: str = "any4", group_size: int = 128,
                    row_shards: int = 1, **kwargs) -> QuantizedTensor:
    """Quantize a 2-D weight ``[n, k]`` on its own device.

    ``kwargs`` go to the any4 learner for the any4 formats (sample_weight,
    init, kmeans_iters, keep_outliers, ...) and are not read by the others;
    ``layout="row"`` keeps the ``any4``/``nf4``/``fp4``/``int4`` name at
    ``g % 128 == 0``. ``scale_only`` (symmetric) applies to any4 and the
    integer formats, ``int_zeros`` (integer zero points) to the integer
    formats.
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
    symmetric = bool(kwargs.pop("scale_only", False))
    int_zeros = bool(kwargs.pop("int_zeros", False))
    if int_zeros and fmt not in INT_FMTS:
        raise ValueError(f"int_zeros applies to int formats, not {fmt!r}")
    if fmt in INT_FMTS:
        return _quantize_int(w, fmt, group_size, layout, symmetric, int_zeros)
    base = fmt.rstrip("t")
    if symmetric and base != "any4":
        raise ValueError(f"scale_only applies to int/any4 formats, not "
                         f"{fmt!r}")
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
    return _packed(codes, scales, zeros, lut.contiguous(), fmt, group_size,
                   w.dtype)


def _packed(codes, scales, zeros, lut, fmt, group_size, dtype):
    n, k = codes.shape
    scales = packing.pad_groups(scales, k, group_size)
    zeros = packing.pad_groups(zeros, k, group_size)
    return QuantizedTensor(packing.pack_codes(codes), scales.t().contiguous(),
                           zeros.t().contiguous(), lut, fmt, group_size,
                           (n, k), dtype, 1)


def _quantize_int(w, fmt, group_size, layout, symmetric, int_zeros):
    """``int4``/``int4p``/``w4a8``: uniform group quantization, no LUT. The
    format checks and the int4 -> int4p rename are the JAX package's."""
    n = w.shape[0]
    if fmt == "int4" and layout != "row" and group_size % 128 == 0 \
            and n % 2 == 0:
        fmt = "int4p"       # the JAX default: pair-packed magic-number int4
    if fmt in ("int4p", "w4a8") and group_size % 128:
        raise ValueError(f"{fmt} requires group_size a multiple of 128, got "
                         f"{group_size}")
    if fmt == "int4p" and n % 2:
        raise ValueError(f"int4p pair packing needs an even n, got {n}")
    if fmt == "w4a8" and n % 4:
        raise ValueError(f"w4a8 quad packing requires n % 4 == 0, got {n}")
    codes, scales, zeros = quant.group_quantize(
        w, 4, group_size, symmetric=symmetric, int_zeros=int_zeros)
    return _packed(codes, scales, zeros, None, fmt, group_size, w.dtype)


def dequantize_tensor(qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """Reconstruct the dense weight ``[n, k]``: ``lut[code] * s + z`` (or
    ``(code - 8) * s + z`` without a LUT) in f32, a multiply and then an
    add, cast to ``dtype`` (default: the weight's)."""
    n, k = qt.shape
    kp = qt.packed.shape[1] * packing.CODES_PER_WORD
    codes = packing.unpack_codes(qt.packed, kp).long()
    if qt.lut is None:
        q = (codes - 8).float()
    else:
        q = torch.gather(qt.lut.float().expand(n, 16), 1, codes)
    g = qt.group_size
    scales = torch.repeat_interleave(qt.scales.t(), g, dim=1)[:, :kp]
    zeros = torch.repeat_interleave(qt.zeros.t(), g, dim=1)[:, :kp]
    w = q[:, :scales.shape[1]] * scales + zeros
    return w[:, :k].to(dtype or qt.dtype)


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
           fused_m_max: int = FUSED_M_MAX,
           use_gather: bool = True) -> torch.Tensor:
    """``y = x @ W^T + bias`` where ``w`` is dense ``[n, k]`` or a
    :class:`QuantizedTensor`.

    ``w4a8`` runs its kernel at every m: up to ``gemv.FUSED_ACT_M_MAX``
    rows in one call that quantizes the activations itself, above that
    after :func:`quantize_activations`, in chunks of ``_int8_m_tile(k)``
    rows once m exceeds ``max(fused_m_max, _int8_m_tile(k))``. The other
    formats run the fused kernel for ``m <= fused_m_max`` rows in one call,
    larger ``m`` in chunks of ``fused_m_max`` rows, and ``fused_m_max=0``
    dequantizes and runs a plain matmul. ``use_gather=False`` takes the
    select-LUT kernel for the row-layout 4-bit formats.
    """
    if not isinstance(w, QuantizedTensor):
        y = torch.matmul(x, w.to(x.dtype).t())
    elif w.fmt == "w4a8":
        y = _w4a8_linear(x, w, fused_m_max)
    elif fused_m_max > 0:
        m = x.numel() // x.shape[-1]
        kfmt = _kernel_fmt(w.fmt, w.lut)

        def mm(xc):
            return gemv.quantized_matmul(xc, w.packed, w.scales, w.zeros,
                                         w.lut, group_size=w.group_size,
                                         out_dtype=x.dtype, fmt=kfmt,
                                         use_gather=use_gather)

        y = _chunked(mm, x, m, fused_m_max, fused_m_max, w.shape[0])
    else:
        y = torch.matmul(x, dequantize_tensor(w, dtype=x.dtype).t())
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _chunked(mm, x, m, one_call_max, tile, n):
    """``mm(x)`` in one call for ``m <= one_call_max`` rows, else over
    chunks of ``tile`` rows, concatenated."""
    if m <= one_call_max:
        return mm(x)
    x2 = x.reshape(m, x.shape[-1])
    y = torch.cat([mm(x2[i:i + tile]) for i in range(0, m, tile)])
    return y.reshape(*x.shape[:-1], n)


def _w4a8_linear(x, w, fused_m_max):
    m = x.numel() // x.shape[-1]

    def mm(xc, out_dtype):
        return gemv.quantized_matmul(xc, w.packed, w.scales, w.zeros,
                                     group_size=w.group_size,
                                     out_dtype=out_dtype, fmt="w4a8")

    if m <= gemv.FUSED_ACT_M_MAX:
        return mm(x, x.dtype)
    xq, sx = quantize_activations(x)
    tile = _int8_m_tile(w.shape[1])
    y = _chunked(lambda xc: mm(xc, torch.float32), xq, m,
                 max(fused_m_max, tile), tile, w.shape[0])
    return (y * sx).to(x.dtype)
