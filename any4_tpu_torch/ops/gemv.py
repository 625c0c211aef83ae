"""Fused 4-bit LUT matmuls: wrappers of the CUDA kernels, their plain
PyTorch versions and launch counts (counterpart of
``any4_tpu/ops/pallas/gemv.py``).

Two kernels, both in ``csrc/q4_lut_gemv.cu``:

- :func:`q4_lut_post` (kernel A) replaces ``_q4t_kernel`` and
  ``_q4post_kernel``: the LUT is rounded to bf16 before the dot, bf16 x
  times the LUT values are summed in f32 per group, and the group affine is
  applied after the dot, ``y += P_g * s_g + sum(x_g) * z_g``. Group sizes
  that are multiples of 128.
- :func:`q4_lut_fused` (kernel B) replaces ``_q4_kernel``: each weight is
  ``bf16(lut[c] * s + z)`` (one fused multiply-add in f32, then one bf16
  rounding) and the dot with bf16 x accumulates in f32. Group sizes that
  are multiples of 8 (16, 32, 64 on the main path).

Operands (the layout of :mod:`.packing`): ``packed [n, kp/8]`` int32,
``scales``/``zeros`` ``[kp/g, n]`` f32, ``lut`` ``[n, 16]`` (per row) or
``[1, 16]`` (global) f32, centered. ``x`` is ``[m, k]`` with ``k <= kp``; it
is cast to bf16 first, as the TPU wrapper does.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the kernel or raises. Each launch adds one to
``LAUNCHES[name]``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .packing import PACK_BLOCK, unpack_codes
from .quant import fma

LAUNCHES = {"q4_lut_post": 0, "q4_lut_fused": 0}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SOURCE = "q4_lut_gemv.cu"
_FNS = {}   # name -> ctypes function, filled at first launch


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lut_values(packed: torch.Tensor, lut: torch.Tensor):
    """``lut[row, code]`` for every weight, ``[n, kp]`` f32."""
    codes = unpack_codes(packed, packed.shape[1] * 8).long()
    return torch.gather(lut.float().expand(packed.shape[0], 16), 1, codes)


def _x_groups(x: torch.Tensor, num_groups: int, group_size: int):
    """bf16-rounded x as f32, zero-padded or cut to the groups' k."""
    m, k = x.shape
    kg = num_groups * group_size
    xb = torch.zeros((m, kg), dtype=torch.float32, device=x.device)
    xb[:, :min(k, kg)] = x[:, :kg].to(torch.bfloat16).float()
    return xb


def q4_lut_post_plain(x, packed, scales, zeros, lut, group_size, out_dtype):
    """Kernel A's function in plain PyTorch, with its rounding points."""
    m = x.shape[0]
    n = packed.shape[0]
    G = scales.shape[0]
    kg = G * group_size
    w = _lut_values(packed, lut.to(torch.bfloat16))
    xb = _x_groups(x, G, group_size).reshape(m, G, group_size)
    P = torch.einsum("mgk,ngk->mgn", xb, w[:, :kg].reshape(n, G, group_size))
    xs = xb.sum(dim=-1)                                   # [m, G]
    y = (P * scales[None]).sum(dim=1) + xs @ zeros
    return y.to(out_dtype)


def q4_lut_fused_plain(x, packed, scales, zeros, lut, group_size, out_dtype):
    """Kernel B's function in plain PyTorch, with its rounding points."""
    G = scales.shape[0]
    kg = G * group_size
    vals = _lut_values(packed, lut)[:, :kg]
    s = torch.repeat_interleave(scales.t(), group_size, dim=1)
    z = torch.repeat_interleave(zeros.t(), group_size, dim=1)
    w = fma(vals, s, z).to(torch.bfloat16).float()        # [n, kg]
    return (_x_groups(x, G, group_size) @ w.t()).to(out_dtype)


def _launch(name, x, packed, scales, zeros, lut, group_size, out_dtype):
    dev = x.device
    for t, nm in ((packed, "packed"), (scales, "scales"), (zeros, "zeros"),
                  (lut, "lut")):
        if t.device != dev:
            raise ValueError(f"{name}: {nm} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    n, kw = packed.shape
    G = scales.shape[0]
    if packed.dtype != torch.int32 or (kw * 8) % PACK_BLOCK:
        raise ValueError(f"{name}: packed must be int32 [n, kp/8] with kp a "
                         f"multiple of {PACK_BLOCK}, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if scales.dtype != torch.float32 or zeros.dtype != torch.float32 \
            or scales.shape != (G, n) or zeros.shape != (G, n):
        raise ValueError(f"{name}: scales/zeros must be f32 [kp/g, n={n}]")
    if lut.dtype != torch.float32 or lut.shape not in ((n, 16), (1, 16)):
        raise ValueError(f"{name}: lut must be f32 [n, 16] or [1, 16], got "
                         f"{lut.dtype} {tuple(lut.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{name}: unsupported output dtype {out_dtype}")
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must be 16-byte aligned")
    m, k = x.shape
    if k > kw * 8:
        raise ValueError(f"{name}: x has k={k} > packed kp={kw * 8}")
    xb = x.to(torch.bfloat16).contiguous()
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return y
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(build.load(_SOURCE), name)
    err = fn(xb.data_ptr(), packed.data_ptr(), scales.data_ptr(),
             zeros.data_ptr(), lut.data_ptr(), y.data_ptr(), m, n, k, kw,
             group_size, G, 16 if lut.shape[0] == n and n > 1 else 0,
             _OUT_DTYPES[out_dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def _dispatch(name, plain, x, packed, scales, zeros, lut, group_size,
              out_dtype):
    if x.device.type == "cpu":
        return plain(x, packed, scales, zeros, lut, group_size, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return _launch(name, x, packed, scales, zeros, lut, group_size, out_dtype)


def q4_lut_post(x, packed, scales, zeros, lut, group_size, out_dtype):
    """Kernel A on ``x [m, k]``; returns ``[m, n]`` of ``out_dtype``."""
    if group_size % 128:
        raise ValueError(f"q4_lut_post needs group_size % 128 == 0, got "
                         f"{group_size}")
    return _dispatch("q4_lut_post", q4_lut_post_plain, x, packed, scales,
                     zeros, lut, group_size, out_dtype)


def q4_lut_fused(x, packed, scales, zeros, lut, group_size, out_dtype):
    """Kernel B on ``x [m, k]``; returns ``[m, n]`` of ``out_dtype``."""
    if group_size % 8:
        raise ValueError(f"q4_lut_fused needs group_size % 8 == 0, got "
                         f"{group_size}")
    return _dispatch("q4_lut_fused", q4_lut_fused_plain, x, packed, scales,
                     zeros, lut, group_size, out_dtype)


def quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, zeros: torch.Tensor,
                     lut: torch.Tensor, *, group_size: int,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y = x @ dequant(W)^T`` for ``x [..., k]``: kernel A at group sizes
    that are multiples of 128, kernel B below."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out_dtype = out_dtype or x.dtype
    fn = q4_lut_post if group_size % 128 == 0 else q4_lut_fused
    y = fn(x2, packed, scales, zeros, lut, group_size, out_dtype)
    return y.reshape(*lead, packed.shape[0])
