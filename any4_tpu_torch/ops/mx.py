"""The MX (microscaling) element library (counterpart of
``any4_tpu/ops/mx.py``): element formats int2..int8, fp4, fp6_e2m3/e3m2,
fp8_e4m3/e5m2, fp16 and bf16, floor/nearest/even mantissa rounding,
denormal control, and the shared-exponent MX block quantizer
:func:`quantize_mx`, of which the ``mx4`` weight format
(:func:`.quant.mx4_quantize`) is a special case.

Plain functions on float32 tensors. The base-2 logarithms and powers are
the JAX package's on the CPU (:func:`.quant.log2`, :func:`.quant.pow2`),
and ``sign`` keeps a NaN and the sign of a zero as ``jnp.sign`` does, so
the results are JAX's bits for normal float32 inputs.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from .quant import FP32_MIN_NORMAL, log2, pow2

FP32_EXPONENT_BIAS = 127


def _min_norm(ebits: int) -> float:
    return 0.0 if ebits == 0 else 2.0 ** (2 - 2 ** (ebits - 1))


@functools.lru_cache(maxsize=None)
def format_params(fmt: str) -> Tuple[int, int, int, float, float]:
    """``(ebits, mbits, emax, max_norm, min_norm)`` of an element format;
    ``mbits`` counts the sign and the implicit one."""
    fmt = fmt.lower()
    table = {
        "int8": (0, 8, 0),
        "int4": (0, 4, 0),
        "int2": (0, 2, 0),
        "fp8_e5m2": (5, 4, 2 ** 4 - 1),
        "fp8_e4m3": (4, 5, 2 ** 3),
        "fp6_e3m2": (3, 4, 2 ** 2),
        "fp6_e2m3": (2, 5, 2 ** 1),
        "fp4": (2, 3, 2 ** 1),
        "fp4_e2m1": (2, 3, 2 ** 1),
        "float16": (5, 12, 2 ** 4 - 1),
        "fp16": (5, 12, 2 ** 4 - 1),
        "bfloat16": (8, 9, 2 ** 7 - 1),
        "bf16": (8, 9, 2 ** 7 - 1),
    }
    if fmt not in table:
        raise ValueError(f"unknown mx element format {fmt!r}; "
                         f"have {sorted(table)}")
    ebits, mbits, emax = table[fmt]
    if fmt == "fp8_e4m3":
        max_norm = 2.0 ** emax * 1.75      # the top mantissa is NaN
    else:
        max_norm = 2.0 ** emax * float(2 ** (mbits - 1) - 1) \
            / 2 ** (mbits - 2)
    return ebits, mbits, emax, max_norm, _min_norm(ebits)


def _sign(a: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, 1, or ``a`` itself for a zero or a NaN."""
    return torch.where((a == 0) | torch.isnan(a), a, torch.sign(a))


def round_mantissa(a: torch.Tensor, bits: int, round: str = "nearest",
                   clamp: bool = False) -> torch.Tensor:
    """Round a pre-scaled mantissa to an integer: ``floor`` (toward zero),
    ``nearest`` (half away from zero) or ``even`` (half to even)."""
    absa = a.abs()
    if round == "floor":
        out = _sign(a) * torch.floor(absa)
    elif round == "nearest":
        out = _sign(a) * torch.floor(absa + 0.5)
    elif round == "even":
        # a tie whose truncation is already even rounds toward zero: those
        # are the values where |a| - 0.5 is an even integer
        mask = (torch.fmod(absa - 0.5, 2.0) == 0).to(a.dtype)
        out = _sign(a) * (torch.floor(absa + 0.5) - mask)
    else:
        raise ValueError(f"unrecognized round mode {round!r}")
    if clamp:
        m = 2 ** (bits - 1) - 1
        out = torch.clamp(out, -m, m)
    return out


def quantize_elemwise(a: torch.Tensor, bits: int, exp_bits: int,
                      max_norm: float, round: str = "nearest",
                      saturate_normals: bool = False,
                      allow_denorm: bool = True) -> torch.Tensor:
    """Quantize each element to a (sign, ``exp_bits``, ``bits - 2``
    mantissa) grid. NaN and Inf pass through; overflow saturates
    (``saturate_normals`` or integer formats) or becomes Inf."""
    a = a.float()
    out = a
    if not allow_denorm and exp_bits > 0:
        out = torch.where(a.abs() >= _min_norm(exp_bits), out,
                          torch.zeros_like(out))
    if exp_bits != 0:
        private_exp = torch.floor(log2(a.abs() + (a == 0).to(a.dtype)))
        min_exp = -(2 ** (exp_bits - 1)) + 2
        private_exp = torch.clamp(private_exp, min=min_exp)
        shift = pow2(bits - 2 - private_exp)
    else:
        shift = torch.tensor(2.0 ** (bits - 2), device=a.device)
    out = round_mantissa(out * shift, bits, round, clamp=False) / shift
    if saturate_normals or exp_bits == 0:
        out = torch.clamp(out, -max_norm, max_norm)
    else:
        out = torch.where(out.abs() > max_norm, _sign(out) * float("inf"),
                          out)
    return torch.where(torch.isfinite(a), out, a)


def quantize_float(a: torch.Tensor, fmt: str, round: str = "nearest",
                   allow_denorm: bool = True) -> torch.Tensor:
    """Fake-quantize to a standalone small float format."""
    ebits, mbits, _, max_norm, _ = format_params(fmt)
    return quantize_elemwise(a, mbits, ebits, max_norm, round=round,
                             saturate_normals=False,
                             allow_denorm=allow_denorm)


def shared_exponents(a: torch.Tensor, method: str = "max",
                     rounding_mode: str = "even",
                     axes: Optional[Sequence[int]] = None,
                     ebits: int = 0) -> torch.Tensor:
    """The shared exponent of each reduction group: ``floor``/``ceil`` of
    ``log2`` of the group's max |a|, or (``even``) of the max |a| first
    rounded to a power of two in its float32 bits."""
    if method == "max":
        amax = a.abs()
        if axes is None:
            amax = amax.amax()
        else:
            for ax in sorted(axes):
                amax = amax.amax(dim=ax, keepdim=True)
    elif method == "none":
        amax = a.abs()
    else:
        raise ValueError(f"unrecognized shared-exp method {method!r}")
    amax = amax.float()
    if rounding_mode == "even":
        # add half an ulp of the exponent, keep the sign and exponent bits
        # (0xFF800000)
        bits = (amax.view(torch.int32) + (1 << 22)) & (-(1 << 23))
        amax = bits.view(torch.float32)
    elif rounding_mode not in ("ceil", "floor"):
        raise ValueError(f"unrecognized rounding mode {rounding_mode!r}")
    lg = log2(amax + FP32_MIN_NORMAL * (amax == 0).to(amax.dtype))
    exp = torch.ceil(lg) if rounding_mode == "ceil" else torch.floor(lg)
    if ebits > 0:
        emax = 2 ** (ebits - 1) - 1
        exp = torch.where(exp > emax, torch.full_like(exp, float("nan")),
                          exp)
        exp = torch.clamp(exp, min=-emax)
    return exp


def quantize_mx(a: torch.Tensor, elem_format: str, block_size: int = 32,
                axis: int = -1, scale_bits: int = 8,
                round: str = "nearest",
                shared_exp_method: str = "max",
                block_scale_rounding_mode: str = "even",
                flush_fp32_subnorms: bool = False) -> torch.Tensor:
    """Fake-quantize ``a`` to an MX format: ``block_size`` elements along
    ``axis`` share one power-of-two scale (a ``scale_bits``-wide exponent,
    e8m0 at 8) and each element is quantized to ``elem_format``. mx4 is
    ``elem_format="fp4", block_size=32``."""
    if elem_format is None:
        return a
    if scale_bits <= 0:
        raise ValueError(f"scale_bits must be positive, got {scale_bits}")
    ebits, mbits, emax, max_norm, _ = format_params(elem_format)
    axis = axis + a.dim() if axis < 0 else axis
    L = a.shape[axis]
    pad = (-L) % block_size
    a32 = a.float()
    if pad:
        widths = [0, 0] * (a.dim() - 1 - axis) + [0, pad]
        a32 = torch.nn.functional.pad(a32, widths)
    shape = list(a32.shape)
    shape[axis:axis + 1] = [shape[axis] // block_size, block_size]
    blocks = a32.reshape(shape)

    exp = shared_exponents(blocks, method=shared_exp_method,
                           rounding_mode=block_scale_rounding_mode,
                           axes=[axis + 1], ebits=0)
    if flush_fp32_subnorms:
        blocks = blocks * (exp > -FP32_EXPONENT_BIAS).to(blocks.dtype)
    exp = exp - emax
    scale_emax = 2 ** (scale_bits - 1) - 1
    exp = torch.where(exp > scale_emax, torch.full_like(exp, float("nan")),
                      exp)
    exp = torch.clamp(exp, min=-scale_emax)

    scale = pow2(exp)
    q = quantize_elemwise(blocks / scale, mbits, ebits, max_norm,
                          round=round, saturate_normals=True,
                          allow_denorm=True) * scale
    q = q.reshape(a32.shape)
    if pad:
        q = q.narrow(axis, 0, L)
    return q.to(a.dtype) if a.dtype.is_floating_point else q
