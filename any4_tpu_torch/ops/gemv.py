"""Fused 4-bit matmuls: wrappers of the CUDA kernels, their plain PyTorch
versions and launch counts (counterpart of ``any4_tpu/ops/pallas/gemv.py``).

Six kernels. In ``csrc/q4_lut_gemv.cu``, four modes of one body:

- :func:`q4_lut_post` (kernel A) replaces ``_q4t_kernel`` and
  ``_q4post_kernel``: the LUT is rounded to bf16 before the dot, bf16 x
  times the LUT values are summed in f32 per group, and the group affine is
  applied after the dot, ``y += P_g * s_g + sum(x_g) * z_g``. Group sizes
  that are multiples of 128.
- :func:`q4_lut_fused` (kernel B) replaces ``_q4_kernel``: each weight is
  ``bf16(lut[c] * s + z)`` (one fused multiply-add in f32, then one bf16
  rounding) and the dot with bf16 x accumulates in f32. Group sizes that
  are multiples of 8. Row-layout int4 runs here at every group size, with
  the ramp ``lut = c - 8`` (:data:`INT4_RAMP`).
- :func:`q4_int4_magic` (kernel C) replaces ``_q4pair_kernel`` (int4p):
  ``(w >> 4p) & 0x000F000F | 0x43004300`` read as bf16 is ``128 + c``; per
  128-wide slice ``y += P * s + sum(x) * (z - 136 s)``, with ``P`` the f32
  dot of bf16 x and ``128 + c``. Group sizes that are multiples of 128.
- :func:`q4_lut_select` (kernel E) replaces ``_q4select_kernel``: kernel B's
  function with the LUT value picked by 16 compare-selects instead of a
  table read; equal to kernel B bit for bit. Group sizes that are multiples
  of 128 (``linear(..., use_gather=False)``).

In ``csrc/w4a8_gemv.cu``, two entry points of one body (the int4 codes of
the ``w4a8`` format times int8 activations, exact int32 dots per 128-wide
slice, ``y += P * s + sum(xq) * (z - 8 s)`` in f32):

- :func:`w4a8` (kernel D) replaces ``_w4a8_kernel``: int8 x quantized
  outside (:func:`~.quant.quantize_activations`), f32 y that the caller
  multiplies by ``sx``;
- :func:`w4a8_fused` (kernel D-fused) replaces ``_w4a8f_kernel``: float x
  as it comes, quantized per row inside the kernel with the same math, and
  ``y * sx`` written in ``out_dtype``.

Operands (the layout of :mod:`.packing`): ``packed [n, kp/8]`` int32,
``scales``/``zeros`` ``[kp/g, n]`` f32, ``lut`` ``[n, 16]`` (per row) or
``[1, 16]`` (global) f32, centered. ``x`` is ``[m, k]`` with ``k <= kp``;
the q4 kernels cast it to bf16 first, as the TPU wrapper does, and the
W4A8 kernels keep its precision.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the kernel or raises. Each launch adds one to
``LAUNCHES[name]``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .packing import PACK_BLOCK, unpack_codes
from .quant import fma, quantize_activations

LAUNCHES = {"q4_lut_post": 0, "q4_lut_fused": 0, "q4_int4_magic": 0,
            "q4_lut_select": 0, "w4a8": 0, "w4a8_fused": 0}
_SOURCES = {"q4_lut_post": "q4_lut_gemv.cu", "q4_lut_fused": "q4_lut_gemv.cu",
            "q4_int4_magic": "q4_lut_gemv.cu",
            "q4_lut_select": "q4_lut_gemv.cu",
            "w4a8": "w4a8_gemv.cu", "w4a8_fused": "w4a8_gemv.cu"}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_W4A8_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 3}
_FNS = {}   # name -> ctypes function, filled at first launch
_RAMPS = {}  # device -> int4 ramp LUT
# Largest m whose activations the w4a8 kernel quantizes itself. 64 is the
# TPU kernel's VMEM budget for a whole activation row; it is kept so that
# routing and launch counts match the JAX package, and is not a Hopper
# measurement.
FUSED_ACT_M_MAX = 64
SLICE = 128          # k per post-dot affine (one TPU lane plane)
# the uniform int4 codebook, centered: code c reconstructs as (c - 8) s + z
INT4_RAMP = [float(c - 8) for c in range(16)]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def int4_ramp(device) -> torch.Tensor:
    """:data:`INT4_RAMP` as a global ``[1, 16]`` f32 LUT, made once per
    device."""
    ramp = _RAMPS.get(device)
    if ramp is None:
        ramp = _RAMPS[device] = torch.tensor(
            [INT4_RAMP], dtype=torch.float32, device=device)
    return ramp


def _lut_values(packed: torch.Tensor, lut: torch.Tensor):
    """``lut[row, code]`` for every weight, ``[n, kp]`` f32."""
    codes = unpack_codes(packed, packed.shape[1] * 8).long()
    return torch.gather(lut.float().expand(packed.shape[0], 16), 1, codes)


def _x_groups(x: torch.Tensor, num_groups: int, group_size: int,
              dtype=torch.bfloat16):
    """x rounded to ``dtype`` (bf16 for the q4 kernels) as f32, zero-padded
    or cut to the groups' k."""
    m, k = x.shape
    kg = num_groups * group_size
    xb = torch.zeros((m, kg), dtype=torch.float32, device=x.device)
    xb[:, :min(k, kg)] = x[:, :kg].to(dtype).float()
    return xb


def _per_slice(a: torch.Tensor, group_size: int) -> torch.Tensor:
    """``[kp/g, n]`` scales or zeros as one row per 128-wide k slice (the
    TPU's ``_expand_plane_scales``)."""
    return torch.repeat_interleave(a, group_size // SLICE, dim=0)


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


def _fused_table_matmul(x, vals, scales, zeros, group_size, out_dtype):
    """``x @ bf16(vals * s + z)^T`` with one f32 rounding per weight."""
    G = scales.shape[0]
    s = torch.repeat_interleave(scales.t(), group_size, dim=1)
    z = torch.repeat_interleave(zeros.t(), group_size, dim=1)
    w = fma(vals[:, :G * group_size], s, z).to(torch.bfloat16).float()
    return (_x_groups(x, G, group_size) @ w.t()).to(out_dtype)


def q4_lut_fused_plain(x, packed, scales, zeros, lut, group_size, out_dtype):
    """Kernel B's function in plain PyTorch, with its rounding points."""
    return _fused_table_matmul(x, _lut_values(packed, lut), scales, zeros,
                               group_size, out_dtype)


def q4_lut_select_plain(x, packed, scales, zeros, lut, group_size,
                        out_dtype):
    """Kernel E's function in plain PyTorch: kernel B's, with each LUT value
    picked by 16 compare-selects."""
    n = packed.shape[0]
    codes = unpack_codes(packed, packed.shape[1] * 8)
    table = lut.float().expand(n, 16)
    vals = torch.zeros(codes.shape, dtype=torch.float32, device=x.device)
    for c in range(16):
        vals = torch.where(codes == c, table[:, c:c + 1], vals)
    return _fused_table_matmul(x, vals, scales, zeros, group_size, out_dtype)


def _slice_affine(P, xs, scales, zeros, group_size, zero_shift):
    """``sum over 128-wide slices of P * s + xs * (z - zero_shift * s)``;
    ``P [m, S, n]``, ``xs [m, S]``."""
    s = _per_slice(scales, group_size)[None]               # [1, S, n]
    z = _per_slice(zeros, group_size)[None]
    return (P * s + xs[..., None] * (z - zero_shift * s)).sum(dim=1)


def q4_int4_magic_plain(x, packed, scales, zeros, lut, group_size,
                        out_dtype):
    """Kernel C's function in plain PyTorch: the dot of bf16 x with the
    ``128 + c`` weights in f32, then ``P * s + sum(x) * (z - 136 s)`` per
    128-wide slice (``lut`` is not read)."""
    m, n = x.shape[0], packed.shape[0]
    S = scales.shape[0] * group_size // SLICE
    v = unpack_codes(packed, S * SLICE).float().add_(128.0)
    xb = _x_groups(x, S, SLICE).reshape(m, S, SLICE)
    P = torch.einsum("msk,nsk->msn", xb, v.reshape(n, S, SLICE))
    return _slice_affine(P, xb.sum(dim=-1), scales, zeros, group_size,
                         136.0).to(out_dtype)


def _w4a8_dot(xq, packed, scales, zeros, group_size):
    """int8 ``xq`` times the codes per 128-wide slice (exact: every partial
    sum is an integer below 2^24), then ``P * s + sum(xq) * (z - 8 s)`` in
    f32."""
    m, n = xq.shape[0], packed.shape[0]
    S = scales.shape[0] * group_size // SLICE
    c = unpack_codes(packed, S * SLICE).float().reshape(n, S, SLICE)
    xf = _x_groups(xq, S, SLICE, torch.float32).reshape(m, S, SLICE)
    P = torch.einsum("msk,nsk->msn", xf, c)
    return _slice_affine(P, xf.sum(dim=-1), scales, zeros, group_size, 8.0)


def w4a8_plain(x, packed, scales, zeros, group_size, out_dtype):
    """Kernel D's function in plain PyTorch (int8 ``x``)."""
    return _w4a8_dot(x, packed, scales, zeros, group_size).to(out_dtype)


def w4a8_fused_plain(x, packed, scales, zeros, group_size, out_dtype):
    """Kernel D-fused's function in plain PyTorch: the row quantization of
    :func:`~.quant.quantize_activations`, kernel D's dot, then ``y * sx``."""
    xq, sx = quantize_activations(x)
    y = _w4a8_dot(xq, packed, scales, zeros, group_size)
    return (y * sx).to(out_dtype)


def _fn(name):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(build.load(_SOURCES[name]), name)
    return fn


def _check_operands(name, x, packed, scales, zeros, lut, out_dtype):
    """Devices, types, shapes and contiguity the kernels take; raises on
    anything else. Returns ``(n, kw, G)``."""
    dev = x.device
    for t, nm in ((packed, "packed"), (scales, "scales"), (zeros, "zeros"),
                  (lut, "lut")):
        if t is None:
            continue
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
    if lut is not None and (lut.dtype != torch.float32
                            or lut.shape not in ((n, 16), (1, 16))):
        raise ValueError(f"{name}: lut must be f32 [n, 16] or [1, 16], got "
                         f"{lut.dtype} {tuple(lut.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{name}: unsupported output dtype {out_dtype}")
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must be 16-byte aligned")
    if x.shape[1] > kw * 8:
        raise ValueError(f"{name}: x has k={x.shape[1]} > packed kp={kw * 8}")
    return n, kw, G


def _launch_q4(name, x, packed, scales, zeros, lut, group_size, out_dtype):
    n, kw, G = _check_operands(name, x, packed, scales, zeros, lut,
                               out_dtype)
    m, k = x.shape
    xb = x.to(torch.bfloat16).contiguous()
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return y
    per_row = lut is not None and lut.shape[0] == n and n > 1
    err = _fn(name)(
        xb.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        zeros.data_ptr(), 0 if lut is None else lut.data_ptr(), y.data_ptr(),
        m, n, k, kw, group_size, G, 16 if per_row else 0,
        _OUT_DTYPES[out_dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def _launch_w4a8(name, x, packed, scales, zeros, group_size, out_dtype):
    n, kw, G = _check_operands(name, x, packed, scales, zeros, None,
                               out_dtype)
    m, k = x.shape
    if x.dtype == torch.float16:
        x = x.float()          # exact; the kernel reads bf16, f32 or int8
    if x.dtype not in _W4A8_X_DTYPES or \
            (x.dtype == torch.int8) != (name == "w4a8"):
        raise ValueError(f"{name}: unsupported x dtype {x.dtype}")
    x = x.contiguous()
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return y
    err = _fn(name)(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        y.data_ptr(), m, n, k, kw, group_size, G, _W4A8_X_DTYPES[x.dtype],
        _OUT_DTYPES[out_dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def _dispatch(name, plain, launch, x, *args):
    if x.device.type == "cpu":
        return plain(x, *args)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return launch(name, x, *args)


def _need_group(name, group_size, multiple):
    if group_size % multiple:
        raise ValueError(f"{name} needs group_size % {multiple} == 0, got "
                         f"{group_size}")


def q4_lut_post(x, packed, scales, zeros, lut, group_size, out_dtype):
    """Kernel A on ``x [m, k]``; returns ``[m, n]`` of ``out_dtype``."""
    _need_group("q4_lut_post", group_size, SLICE)
    return _dispatch("q4_lut_post", q4_lut_post_plain, _launch_q4, x, packed,
                     scales, zeros, lut, group_size, out_dtype)


def q4_lut_fused(x, packed, scales, zeros, lut, group_size, out_dtype):
    """Kernel B on ``x [m, k]``; returns ``[m, n]`` of ``out_dtype``."""
    _need_group("q4_lut_fused", group_size, 8)
    return _dispatch("q4_lut_fused", q4_lut_fused_plain, _launch_q4, x,
                     packed, scales, zeros, lut, group_size, out_dtype)


def q4_lut_select(x, packed, scales, zeros, lut, group_size, out_dtype):
    """Kernel E on ``x [m, k]``; returns ``[m, n]`` of ``out_dtype``."""
    _need_group("q4_lut_select", group_size, SLICE)
    return _dispatch("q4_lut_select", q4_lut_select_plain, _launch_q4, x,
                     packed, scales, zeros, lut, group_size, out_dtype)


def q4_int4_magic(x, packed, scales, zeros, group_size, out_dtype):
    """Kernel C on ``x [m, k]``; returns ``[m, n]`` of ``out_dtype``."""
    _need_group("q4_int4_magic", group_size, SLICE)
    return _dispatch("q4_int4_magic", q4_int4_magic_plain, _launch_q4, x,
                     packed, scales, zeros, None, group_size, out_dtype)


def w4a8(x, packed, scales, zeros, group_size, out_dtype=torch.float32):
    """Kernel D on int8 ``x [m, k]``; returns ``[m, n]`` (the caller
    multiplies by the activation scales)."""
    _need_group("w4a8", group_size, SLICE)
    return _dispatch("w4a8", w4a8_plain, _launch_w4a8, x, packed, scales,
                     zeros, group_size, out_dtype)


def w4a8_fused(x, packed, scales, zeros, group_size, out_dtype):
    """Kernel D-fused on float ``x [m, k]``; returns ``[m, n]``."""
    _need_group("w4a8_fused", group_size, SLICE)
    return _dispatch("w4a8_fused", w4a8_fused_plain, _launch_w4a8, x, packed,
                     scales, zeros, group_size, out_dtype)


def quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, zeros: torch.Tensor,
                     lut: Optional[torch.Tensor] = None, *, group_size: int,
                     out_dtype: Optional[torch.dtype] = None,
                     fmt: str = "any4", use_gather: bool = True
                     ) -> torch.Tensor:
    """``y = x @ dequant(W)^T`` for ``x [..., k]``, routed by the kernel
    format name (``linear._kernel_fmt``) as the JAX package routes it:

    - ``any4t``/``lut4t``: kernel A;
    - ``int4p``: kernel C;
    - ``w4a8``: kernel D for int8 x, kernel D-fused for float x (at most
      :data:`FUSED_ACT_M_MAX` rows);
    - ``any4``/``lut4``/``int4`` (row layout): kernel E with
      ``use_gather=False``; else kernel A for ``any4``/``lut4`` at
      ``g % 128 == 0`` and kernel B otherwise, int4 with the ramp LUT.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out_dtype = out_dtype or x.dtype
    g = group_size
    if fmt in ("any4t", "lut4t"):
        y = q4_lut_post(x2, packed, scales, zeros, lut, g, out_dtype)
    elif fmt == "int4p":
        y = q4_int4_magic(x2, packed, scales, zeros, g, out_dtype)
    elif fmt == "w4a8":
        if x2.dtype == torch.int8:
            y = w4a8(x2, packed, scales, zeros, g, out_dtype)
        else:
            if x2.shape[0] > FUSED_ACT_M_MAX:
                raise ValueError(
                    f"w4a8 quantizes activations in the kernel only up to "
                    f"m={FUSED_ACT_M_MAX}; quantize them first "
                    f"(quantize_activations) for m={x2.shape[0]}")
            y = w4a8_fused(x2, packed, scales, zeros, g, out_dtype)
    elif fmt in ("any4", "lut4", "int4"):
        if fmt == "int4":
            lut = int4_ramp(x.device)
        if not use_gather:
            y = q4_lut_select(x2, packed, scales, zeros, lut, g, out_dtype)
        elif fmt != "int4" and g % SLICE == 0:
            y = q4_lut_post(x2, packed, scales, zeros, lut, g, out_dtype)
        else:
            y = q4_lut_fused(x2, packed, scales, zeros, lut, g, out_dtype)
    else:
        raise NotImplementedError(
            f"kernel format {fmt!r} is not ported yet (ROADMAP queue 1, "
            f"item 8)")
    return y.reshape(*lead, packed.shape[0])
