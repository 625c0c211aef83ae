"""Group quantization math (counterpart of ``any4_tpu/ops/quant.py``).

Weight matrices are ``[n, k]`` and are quantized along ``k``. Scales and
zeros come back in the natural ``[n, k/g]`` layout; :mod:`.linear` stores
them transposed as ``[kp/g, n]``.

Every function here is elementwise IEEE arithmetic (subtract, divide,
compare, round half to even), so in float32 it gives the same bits as the
JAX functions run eagerly on the CPU.
"""
from __future__ import annotations

import torch

from .formats import get_table

SCALE_EPS = 1e-6  # (max - min) is clamped to this before dividing
# per-row int8 activation quantization of the W4A8 and W8A8 formats
ACT_QMAX = 127.0
ACT_EPS = 1e-8


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` in float32 rounded once, as a fused multiply-add (and as
    XLA fuses it inside a jitted function). Computed through float64, where
    the product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` rounded once, for a Python number or a tensor ``b``. On
    CUDA, PyTorch divides by a Python number (or a CPU scalar) as a
    multiply by its reciprocal, which rounds twice; a tensor on ``a``'s
    device is divided exactly, as XLA does."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype)
    return a / b.to(a.device)


def _group_view(w: torch.Tensor, group_size: int) -> torch.Tensor:
    n, k = w.shape
    if group_size <= 0:
        group_size = k
    if k % group_size:
        raise ValueError(f"k={k} not divisible by group_size={group_size}")
    return w.reshape(n, k // group_size, group_size)


def group_quantize(w: torch.Tensor, n_bit: int = 4, group_size: int = 128,
                   symmetric: bool = False, int_zeros: bool = False):
    """Per-group uniform quantization, asymmetric by default.

    Returns ``(codes [n, k] uint8, scales [n, k/g], zeros [n, k/g])``;
    reconstruction is ``(code - 2^(n-1)) * scale + zero``.

    - asymmetric: ``scales = max(max - min, 1e-6) / (2^n - 1)``, ``zeros =
      min + scales * 2^(n-1)``, ``codes = clip(round((w - min) / scales))``;
    - ``symmetric`` (scale only): ``scales = max(absmax, 1e-6) /
      (2^(n-1) - 1)``, ``zeros = 0``;
    - ``int_zeros``: the zero point is the integer ``zq = clip(round(-min /
      scales))``, codes are ``clip(round(w / scales) + zq)``, and it is
      folded back as ``zeros = (2^(n-1) - zq) * scales``.
    """
    wg = _group_view(w.float(), group_size)
    half = 2 ** (n_bit - 1)
    max_int = 2 ** n_bit - 1
    if symmetric:
        absmax = wg.abs().amax(dim=-1, keepdim=True)
        scales = div(torch.clamp(absmax, min=SCALE_EPS), half - 1)
        zeros = torch.zeros_like(scales)
        codes = torch.round(wg / scales) + half
    else:
        max_val = wg.amax(dim=-1, keepdim=True)
        min_val = wg.amin(dim=-1, keepdim=True)
        scales = div(torch.clamp(max_val - min_val, min=SCALE_EPS), max_int)
        if int_zeros:
            zq = torch.clamp(torch.round(-min_val / scales), 0, max_int)
            codes = torch.round(wg / scales) + zq
            zeros = (half - zq) * scales
        else:
            zeros = min_val + scales * half
            codes = torch.round((wg - min_val) / scales)
    codes = torch.clamp(codes, 0, max_int).to(torch.uint8).reshape(w.shape)
    return codes, scales[..., 0], zeros[..., 0]


def int8_quantize(w: torch.Tensor, group_size: int = 128,
                  symmetric: bool = False, int_zeros: bool = False):
    """:func:`group_quantize` at 8 bits with the codes stored centered:
    ``(q int8 [n, k] = code - 128 in [-128, 127], scales, zeros)``;
    reconstruction is ``q * scale + zero``."""
    codes, scales, zeros = group_quantize(w, 8, group_size,
                                          symmetric=symmetric,
                                          int_zeros=int_zeros)
    return (codes.to(torch.int32) - 128).to(torch.int8), scales, zeros


def int8_dequantize(q: torch.Tensor, scales: torch.Tensor,
                    zeros: torch.Tensor, group_size: int = 128
                    ) -> torch.Tensor:
    """Inverse of :func:`int8_quantize` (float32 output)."""
    qg = _group_view(q.float(), group_size)
    return (qg * scales[..., None] + zeros[..., None]).reshape(q.shape)


def quantize_activations(x: torch.Tensor, eps: float = ACT_EPS):
    """Per-row absmax int8 quantization of activations, in float32 on ``x``
    as it comes (no bf16 cast): ``sx = max(max|x|, eps) / 127`` over the
    last axis and ``xq = clip(round(x / sx), -127, 127)``, rounding half to
    even. Returns ``(xq int8, sx f32 [..., 1])`` with ``x ~= xq * sx``."""
    xf = x.float()
    sx = div(torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=eps),
             ACT_QMAX)
    xq = torch.clamp(torch.round(xf / sx), -ACT_QMAX, ACT_QMAX)
    return xq.to(torch.int8), sx


def group_dequantize(codes: torch.Tensor, scales: torch.Tensor,
                     zeros: torch.Tensor, n_bit: int = 4,
                     group_size: int = 128) -> torch.Tensor:
    """Inverse of :func:`group_quantize` (float32 output)."""
    cg = _group_view(codes.float(), group_size)
    w = (cg - 2 ** (n_bit - 1)) * scales[..., None] + zeros[..., None]
    return w.reshape(codes.shape)


def group_codes_float(w: torch.Tensor, n_bit: int = 4, group_size: int = 128,
                      symmetric: bool = False):
    """Un-rounded group normalization: ``(w - min) / scale`` in
    ``[0, 2^n-1]``, the domain in which any4 k-means clusters rows.

    ``symmetric=True`` is the scale-only grouping: ``scales =
    absmax/(2^(n-1)-1)``, ``zeros = 0``, values ``w/s + 2^(n-1)``.
    Returns ``(wg_float [n, k], scales [n, k/g], zeros [n, k/g])``.
    """
    wg = _group_view(w.float(), group_size)
    half = 2 ** (n_bit - 1)
    if symmetric:
        absmax = wg.abs().amax(dim=-1, keepdim=True)
        scales = div(torch.clamp(absmax, min=SCALE_EPS), half - 1)
        zeros = torch.zeros_like(scales)
        wq = wg / scales + half
    else:
        max_val = wg.amax(dim=-1, keepdim=True)
        min_val = wg.amin(dim=-1, keepdim=True)
        scales = div(torch.clamp(max_val - min_val, min=SCALE_EPS),
                     2**n_bit - 1)
        zeros = min_val + scales * half
        wq = (wg - min_val) / scales
    return wq.reshape(w.shape), scales[..., 0], zeros[..., 0]


def lut_assign(w: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Nearest-entry assignment of each element of ``w`` to a codebook
    value; ties go to the lower code. Returns uint8 codes, shape of ``w``."""
    d = (w[..., None] - table.to(w.dtype)).abs()
    return torch.argmin(d, dim=-1).to(torch.uint8)


def lut_quantize(w: torch.Tensor, fmt: str = "nf4", group_size: int = 128):
    """Absmax-scaled fixed-codebook quantization (nf4/fp4).

    Each group is divided by its absmax so values land in the table's
    ``[-1, 1]`` domain, then assigned to the nearest entry. Returns
    ``(codes [n, k] uint8, scales [n, k/g])``; reconstruction is
    ``table[code] * scale``.
    """
    table = torch.as_tensor(get_table(fmt), device=w.device)
    wg = _group_view(w.float(), group_size)
    absmax = torch.clamp(wg.abs().amax(dim=-1, keepdim=True), min=SCALE_EPS)
    codes = lut_assign(wg / absmax, table).reshape(w.shape)
    return codes, absmax[..., 0]


def anyq_dequantize(codes: torch.Tensor, lut: torch.Tensor,
                    scales: torch.Tensor, zeros: torch.Tensor,
                    n_bit: int = 4, group_size: int = 128,
                    centered: bool = False) -> torch.Tensor:
    """any4 dequantization: per-row LUT gather + group de-normalization.

    ``lut`` is ``[n, 16]`` (per row) or ``[16]`` (global). With
    ``centered=False`` the LUT holds values in the group-normalized domain
    ``[0, 15]`` and ``2^(n-1)`` is subtracted; with ``centered=True`` the LUT
    is stored pre-centered (``lut - 8``) and used as is.
    """
    idx = codes.long()
    lutf = lut.float()
    if lutf.ndim == 2:
        vals = torch.gather(lutf, 1, idx)
    else:
        vals = lutf[idx]
    if not centered:
        vals = vals - 2 ** (n_bit - 1)
    vg = _group_view(vals, group_size)
    w = vg * scales[..., None] + zeros[..., None]
    return w.reshape(codes.shape)
