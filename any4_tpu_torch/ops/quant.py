"""Group quantization math (counterpart of ``any4_tpu/ops/quant.py``).

Weight matrices are ``[n, k]`` and are quantized along ``k``. Scales and
zeros come back in the natural ``[n, k/g]`` layout; :mod:`.linear` stores
them transposed as ``[kp/g, n]``.

Every function here is elementwise IEEE arithmetic (subtract, divide,
compare, round half to even), so in float32 it gives the same bits as the
JAX functions run eagerly on the CPU. The MX4 functions also take base-2
logarithms and powers, which XLA computes its own way: :func:`log2` and
:func:`exp2` follow it (see there).
"""
from __future__ import annotations

import torch

from .formats import (E8M0_BIAS, FP4_E2M1_EMAX, FP4_E2M1_MAX,
                      FP4_E2M1_TABLE, get_table)

SCALE_EPS = 1e-6  # (max - min) is clamped to this before dividing
# per-row int8 activation quantization of the W4A8 and W8A8 formats
ACT_QMAX = 127.0
ACT_EPS = 1e-8
FP32_MIN_NORMAL = 2.0 ** -126
# XLA's float32 constants: log2(x) is log(x) * (1 / ln 2), exp2(x) is
# exp(x * ln 2)
_INV_LN2 = 1.44269502
_LN2 = 0.693147182
E8M0_NAN = 255  # the e8m0 NaN byte: a group with NaN or an exponent over 127


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` in float32 rounded once, as a fused multiply-add (and as
    XLA fuses it inside a jitted function). Computed through float64, where
    the product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` rounded once, for a Python number or a tensor ``b``. On
    CUDA, PyTorch divides by a Python number (or a CPU scalar) as a
    multiply by its reciprocal, which rounds twice; a tensor on ``a``'s
    device is divided exactly, as XLA does. A Python number is filled into
    such a tensor on the device (a copy from the host would wait for the
    device)."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b.to(a.device)


def _flush(t: torch.Tensor) -> torch.Tensor:
    """Magnitudes below the smallest normal float32 become a zero of their
    sign, as XLA on the CPU flushes them (inputs and results)."""
    return torch.where(t.abs() < FP32_MIN_NORMAL, t * 0.0, t)


def log2(x: torch.Tensor) -> torch.Tensor:
    """``log2`` of float32 ``x`` as the JAX package gets it on the CPU:
    XLA computes ``log(x) * 1.44269502`` in float32 (the division by
    ``log(2)`` becomes a multiply), so just below a power of two the result
    may round up to the integer where ``torch.log2`` does not, or the other
    way. Here the log is the float64 one rounded to float32, then the same
    float32 multiply; ``floor`` of it matched JAX's on every float32 within
    3000 ulps of each normal power of two but one (near 2^94, where XLA's
    own log is an ulp off). Inputs below the smallest normal count as 0."""
    lg = torch.log(_flush(x.float()).double()).float()
    return lg * torch.tensor(_INV_LN2, dtype=torch.float32, device=x.device)


def exp2(x: torch.Tensor) -> torch.Tensor:
    """``2 ** x`` as the JAX package gets it from ``jnp.exp2`` on the CPU:
    ``exp(x * 0.693147182)``, the product rounded to float32 and its exp
    rounded once; so ``exp2(13)`` is 8192.0039, not 8192. Results below the
    smallest normal float32 are 0."""
    prod = x.float() * torch.tensor(_LN2, dtype=torch.float32,
                                    device=x.device)
    return _flush(torch.exp(prod.double()).float())


def pow2(x: torch.Tensor) -> torch.Tensor:
    """``2.0 ** x`` as ``jnp.power`` computes it on the CPU: exact at
    integers, 0 below the smallest normal float32."""
    return _flush(torch.pow(2.0, x.float()))


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


def lut_dequantize(codes: torch.Tensor, scales: torch.Tensor,
                   fmt: str = "nf4", group_size: int = 128) -> torch.Tensor:
    """Inverse of :func:`lut_quantize`: ``table[code] * scale``."""
    table = torch.as_tensor(get_table(fmt), device=codes.device)
    cg = _group_view(table[codes.long()], group_size)
    return (cg * scales[..., None]).reshape(codes.shape)


def pack_scales_and_zeros(scales: torch.Tensor,
                          zeros: torch.Tensor) -> torch.Tensor:
    """``[n, k/g]`` scales and zeros -> the reference's ``[k/g, n, 2]``."""
    return torch.stack([scales, zeros], dim=-1).transpose(0, 1).contiguous()


def unpack_scales_and_zeros(scales_and_zeros: torch.Tensor):
    """Inverse of :func:`pack_scales_and_zeros` -> ``(scales, zeros)``."""
    sz = scales_and_zeros.transpose(0, 1)
    return sz[..., 0], sz[..., 1]


def mx4_quantize(w: torch.Tensor, group_size: int = 32):
    """MX4: fp4_e2m1 elements and one e8m0 exponent a group.

    The exponent is ``floor(log2(max|w|)) - 2`` (:func:`log2`), clamped to
    [-127, 127]; a group whose ``floor(log2(max|w|))`` is -127 or less is
    flushed to 0. Elements are divided by ``2^e`` (:func:`exp2`), clamped
    to +-6 and given the nearest e2m1 magnitude (ties to the lower code)
    with their sign bit: ``code = sign << 3 | magnitude``. A group with NaN,
    or whose exponent was over 127, stores the byte 0xFF (NaN). Returns
    ``(codes uint8 [n, k], exponents uint8 [n, k/g])``, the exponents biased
    by 127. Inputs below the smallest normal float32 count as zeros of their
    sign, as in XLA."""
    wg = _group_view(_flush(w.float()), group_size)
    absmax = wg.abs().amax(dim=-1, keepdim=True)
    has_nan = torch.isnan(wg).any(dim=-1, keepdim=True)
    e = torch.floor(log2(torch.where(absmax > 0, absmax,
                                     torch.ones_like(absmax))))
    wg = torch.where(e <= -E8M0_BIAS, torch.zeros_like(wg), wg)
    e = e - FP4_E2M1_EMAX
    overflow = e > E8M0_BIAS
    e = torch.clamp(e, -E8M0_BIAS, E8M0_BIAS)
    y = torch.clamp(wg / exp2(e), -FP4_E2M1_MAX, FP4_E2M1_MAX)
    mags = torch.as_tensor(FP4_E2M1_TABLE[:8], device=w.device)
    mag = torch.argmin((y.abs()[..., None] - mags).abs(), dim=-1)
    codes = (torch.signbit(y).long() << 3) | mag
    codes = torch.where(torch.isnan(y), torch.zeros_like(codes), codes)
    e_int = (e[..., 0] + E8M0_BIAS).to(torch.uint8)
    e_int = torch.where((overflow | has_nan)[..., 0],
                        torch.full_like(e_int, E8M0_NAN), e_int)
    return codes.to(torch.uint8).reshape(w.shape), e_int


def mx4_scales(exponents: torch.Tensor) -> torch.Tensor:
    """e8m0 exponents -> float32 group scales ``exp2(e - 127)``
    (:func:`exp2`); the byte 0xFF decodes to NaN."""
    e = exponents.float()
    return torch.where(exponents == E8M0_NAN,
                       torch.full_like(e, float("nan")),
                       exp2(e - E8M0_BIAS))


def mx4_dequantize(codes: torch.Tensor, exponents: torch.Tensor,
                   group_size: int = 32) -> torch.Tensor:
    """Inverse of :func:`mx4_quantize`: ``table[code] * scale``."""
    table = torch.as_tensor(FP4_E2M1_TABLE, device=codes.device)
    vals = _group_view(table[codes.long()], group_size)
    return (vals * mx4_scales(exponents)[..., None]).reshape(codes.shape)


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
