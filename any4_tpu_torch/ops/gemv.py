"""Fused 4-bit and int8-weight matmuls: wrappers of the CUDA kernels, their
plain PyTorch versions and launch counts (counterpart of
``any4_tpu/ops/pallas/gemv.py``).

Ten kernels, all on the tensor cores, at every m, in a decode body (m <=
8) and a block body that give the same bits, with k split by
:func:`kernel_a_plan` (:data:`POST_KERNELS`): in ``csrc/q4_lut_gemv.cu``
A, B, C, E, ``int8_post`` and ``int8_fused`` (``mma.sync`` m16n8k16, bf16
in, f32 sums; the bodies are templated on how a code becomes a bf16
value), in ``csrc/w4a8_gemv.cu`` the four W4A8/W8A8 entry points
(``mma.sync`` m16n8k32, int8 in, exact int32 sums per 128-wide slice; the
bodies are templated on the code width, and the fused entry points
quantize float x first):

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
  each weight is ``128 + c`` (a code's nibble or'ed into the bf16 magic
  number ``0x4300``); per 128-wide slice ``y += P * s + sum(x) * (z - 136
  s)``, with ``P`` the f32 dot of bf16 x and ``128 + c``. Group sizes that
  are multiples of 128.
- :func:`q4_lut_select` (kernel E) replaces ``_q4select_kernel``: kernel B's
  function with the LUT value picked by 16 compare-selects instead of a
  table read; B's plan and bodies, so equal to kernel B bit for bit. Group
  sizes that are multiples of 128 (``linear(..., use_gather=False)``).
- :func:`int8_post` replaces ``_int8q_kernel`` and ``_int8t_kernel``: bf16
  x times the int8 codes as bf16 (exact), f32 sums per 128-wide slice, then
  ``y += P * s + sum(x) * z``. Group sizes that are multiples of 128
  (``int8q``/``int8t``/``int8g``).
- :func:`int8_fused` replaces ``_int8_kernel``: kernel B's function with the
  int8 code ``q`` in place of ``lut[c]``, each weight ``bf16(q * s + z)``
  (one fused multiply-add), then the dot in f32; B's plan. Group sizes of
  16 or more that divide 128 or are multiples of it (row-layout ``int8``).

The W4A8 and W8A8 kernels multiply int8 activations with 4-bit or int8
codes, exact int32 dots per 128-wide slice, then ``y += P * s + sum(xq) *
(z - 8 s)`` in f32 for the 4-bit codes and ``y += P * s + sum(xq) * z`` for
the int8 ones:

- :func:`w4a8` (kernel D) replaces ``_w4a8_kernel``: int8 x quantized
  outside (:func:`~.quant.quantize_activations`), f32 y that the caller
  multiplies by ``sx``;
- :func:`w4a8_fused` (kernel D-fused) replaces ``_w4a8f_kernel``: float x
  as it comes, quantized per row inside the kernel with the same math, and
  ``y * sx`` written in ``out_dtype``: on the card the bits of
  ``(w4a8(xq) * sx).to(out_dtype)``;
- :func:`w8a8` replaces ``_w8a8_kernel``, ``_w8a8q_kernel`` and
  ``_w8a8t_kernel``: kernel D on int8 codes;
- :func:`w8a8_fused` replaces ``_w8a8f_kernel``, ``_w8a8qf_kernel`` and
  ``_w8a8tf_kernel``: kernel D-fused on int8 codes.

The TPU kernels that one Hopper kernel replaces compute the same numbers
over different TPU layouts; the port has one layout per code width.

Operands (the layouts of :mod:`.packing`): ``packed [n, kp/8]`` int32 or,
for the four int8-weight kernels, ``[n, kp]`` int8; ``scales``/``zeros``
``[kp/g, n]`` f32, ``lut`` ``[n, 16]`` (per row) or ``[1, 16]`` (global)
f32, centered. ``x`` is ``[m, k]`` with ``k <= kp``; the kernels with
float activations cast it to bf16 first, as the TPU wrapper does, and the
W4A8 and W8A8 kernels keep its precision.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the kernel or raises. Each launch adds one to
``LAUNCHES[name]``. The tensor-core kernels' split-k scratch and ticket
counters, and the fused W4A8/W8A8 kernels' quantized x, are kept per device
and stream (:func:`_split_buffers`, sized by :func:`post_launch_plan`).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .packing import PACK_BLOCK, unpack_codes
from .quant import fma, quantize_activations

_SOURCES = {"q4_lut_post": "q4_lut_gemv.cu", "q4_lut_fused": "q4_lut_gemv.cu",
            "q4_int4_magic": "q4_lut_gemv.cu",
            "q4_lut_select": "q4_lut_gemv.cu",
            "int8_post": "q4_lut_gemv.cu", "int8_fused": "q4_lut_gemv.cu",
            "w4a8": "w4a8_gemv.cu", "w4a8_fused": "w4a8_gemv.cu",
            "w8a8": "w4a8_gemv.cu", "w8a8_fused": "w4a8_gemv.cu"}
LAUNCHES = {name: 0 for name in _SOURCES}
# the kernels that read int8 codes [n, kp]; the others read 4-bit words
BYTE_KERNELS = ("int8_post", "int8_fused", "w8a8", "w8a8_fused")
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the x types of the fused W4A8/W8A8 kernels (float16 x is widened to f32)
_FUSED_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}   # name -> ctypes function, filled at first launch
_RAMPS = {}  # device -> int4 ramp LUT
_SMS = {}    # device -> streaming multiprocessors
_SPLIT_BUFS = {}  # (device, stream) -> the tensor-core kernels' buffers
# the kernels, all on the tensor cores, which take kernel_a_plan's launch
# plan and the split buffers: A, B, C, E, int8_post and int8_fused
# (csrc/q4_lut_gemv.cu, post_mma; bf16 x), D and w8a8 (csrc/w4a8_gemv.cu,
# a8_mma; int8 x) and their fused twins (a8_mma; float x)
POST_KERNELS = ("q4_lut_post", "q4_lut_fused", "q4_int4_magic",
                "q4_lut_select", "int8_post", "int8_fused", "w4a8", "w8a8",
                "w4a8_fused", "w8a8_fused")
# the kernels that read a LUT ([n, 16] per row or [1, 16] global)
LUT_KERNELS = ("q4_lut_post", "q4_lut_fused", "q4_lut_select")
INT8_X_KERNELS = ("w4a8", "w8a8")
FLOAT_X_KERNELS = ("w4a8_fused", "w8a8_fused")
# Their blocks: 64 weight rows each (16 in the decode body); k is split
# until the decode body has about A_DEC_WARPS_PER_SM warps per SM, whatever
# m is.
A_ROWS = 64
A_DEC_WARPS_PER_SM = 16
# Largest m whose activations the W4A8 and W8A8 kernels quantize
# themselves. 64 is the TPU kernel's VMEM budget for a whole activation
# row; it is kept so that routing and launch counts match the JAX package,
# and is not a Hopper measurement.
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


def kernel_a_plan(m: int, n: int, num_groups: int, sms: int):
    """The tensor-core kernels' launch plan: ``(tn, splits,
    groups_per_split, split_blocks)``.

    ``tn`` n8 token tiles (1, 2, 4 or 8: the fewest that hold m, at most
    8). With ``tn`` 1 the decode body runs: a block takes 16 weight rows and
    up to 8 tokens, and its ``min(splits, 16)`` warps take the tile's splits
    in rounds (``split_blocks`` 1). Otherwise the block body runs: a block
    takes 64 rows and ``8 * tn`` tokens, a tile, and sums the tile's splits
    in turn where the tiles alone fill the card (at least ``sms`` of them;
    ``split_blocks`` 1), else each split has a block of its own
    (``split_blocks == splits``) and the last to finish adds them.

    The ``num_groups`` groups of k are cut into ``splits`` runs of
    ``groups_per_split`` (the last may be shorter), as few as give the
    decode body ``A_DEC_WARPS_PER_SM`` warps per SM, one split each for each
    of the ``ceil(n / 16)`` row tiles: a function of ``(n, num_groups,
    sms)`` only, never of m. Each split's sum is its own, and the splits add
    in split order, so a token's sums run in the same order at every m.

    Kernel A folds its affine once per group; C and ``int8_post`` fold once
    per 128-wide slice, so their ``num_groups`` is the slice count ``kp /
    128`` (at g=128 the same number), and B, E and ``int8_fused``, which
    fold nothing, cut their ``ceil(G g / 128)`` slices alike."""
    tn = next((t for t in (1, 2, 4) if m <= 8 * t), 8)
    row_blocks = -(-n // A_ROWS)
    want = min(num_groups, -(-A_DEC_WARPS_PER_SM * sms // -(-n // 16)))
    per = -(-num_groups // max(want, 1))
    splits = -(-num_groups // per)
    tiles = row_blocks * -(-m // (8 * tn))
    return tn, splits, per, 1 if tn == 1 or tiles >= sms else splits


def post_launch_plan(name: str, m: int, n: int, k: int, num_groups: int,
                     group_size: int, sms: int):
    """The launch of one tensor-core kernel: ``(tn, folds_per_split,
    split_blocks, scratch_floats, counter_ints)``. :func:`kernel_a_plan`
    over the kernel's folds (kernel A's groups, the others' 128-wide
    slices: ``ceil(G g / 128)``, which B's group sizes need where g does
    not divide 128), the split-k scratch and tickets that it needs, and for
    the fused W4A8/W8A8 kernels room after the partials for the pre-pass's
    ``sx`` (``ceil(m / 4) * 4`` floats) and ``xq`` (``m * ceil(k / 16) *
    16`` bytes). A fused kernel and its external twin get the same plan, and
    so do B, E and ``int8_fused``."""
    folds = num_groups if name == "q4_lut_post" \
        else -(-num_groups * group_size // SLICE)
    tn, splits, per, split_blocks = kernel_a_plan(m, n, folds, sms)
    tiles = -(-n // A_ROWS) * -(-m // (8 * tn))
    floats = splits * tiles * 8 * tn * A_ROWS if split_blocks > 1 else 0
    if name in FLOAT_X_KERNELS:
        floats += -(-m // 4) * 4 + -(-m * (-(-k // 16) * 16) // 4)
    return tn, per, split_blocks, floats, tiles if split_blocks > 1 else 0


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


def _slice_dot(x, v, scales, zeros, group_size, zero_shift, x_dtype):
    """x rounded to ``x_dtype`` times the weight values ``v [n, >= kp]``
    per 128-wide slice in f32, then :func:`_slice_affine`."""
    m, n = x.shape[0], v.shape[0]
    S = scales.shape[0] * group_size // SLICE
    xs = _x_groups(x, S, SLICE, x_dtype).reshape(m, S, SLICE)
    P = torch.einsum("msk,nsk->msn", xs, v[:, :S * SLICE].reshape(n, S, SLICE))
    return _slice_affine(P, xs.sum(dim=-1), scales, zeros, group_size,
                         zero_shift)


def q4_int4_magic_plain(x, packed, scales, zeros, lut, group_size,
                        out_dtype):
    """Kernel C's function in plain PyTorch: the dot of bf16 x with the
    ``128 + c`` weights in f32, then ``P * s + sum(x) * (z - 136 s)`` per
    128-wide slice (``lut`` is not read)."""
    S = scales.shape[0] * group_size // SLICE
    v = unpack_codes(packed, S * SLICE).float().add_(128.0)
    return _slice_dot(x, v, scales, zeros, group_size, 136.0,
                      torch.bfloat16).to(out_dtype)


def int8_post_plain(x, packed, scales, zeros, group_size, out_dtype):
    """``int8_post``'s function in plain PyTorch: the dot of bf16 x with the
    int8 codes in f32, then ``P * s + sum(x) * z`` per 128-wide slice."""
    return _slice_dot(x, packed.float(), scales, zeros, group_size, 0.0,
                      torch.bfloat16).to(out_dtype)


def int8_fused_plain(x, packed, scales, zeros, group_size, out_dtype):
    """``int8_fused``'s function in plain PyTorch: kernel B's with the code
    ``q`` in place of ``lut[c]``, each weight ``bf16(q * s + z)``."""
    return _fused_table_matmul(x, packed.float(), scales, zeros, group_size,
                               out_dtype)


def _act_dot(xq, packed, scales, zeros, group_size):
    """int8 ``xq`` times the codes per 128-wide slice (exact: every partial
    sum is an integer below 2^24), then ``P * s + sum(xq) * (z - 8 s)``
    (4-bit codes ``c``) or ``P * s + sum(xq) * z`` (int8 codes) in f32."""
    if packed.dtype == torch.int8:
        return _slice_dot(xq, packed.float(), scales, zeros, group_size, 0.0,
                          torch.float32)
    S = scales.shape[0] * group_size // SLICE
    c = unpack_codes(packed, S * SLICE).float()
    return _slice_dot(xq, c, scales, zeros, group_size, 8.0, torch.float32)


def w4a8_plain(x, packed, scales, zeros, group_size, out_dtype):
    """Kernel D's function in plain PyTorch (int8 ``x``); ``w8a8``'s on int8
    codes."""
    return _act_dot(x, packed, scales, zeros, group_size).to(out_dtype)


def w4a8_fused_plain(x, packed, scales, zeros, group_size, out_dtype):
    """Kernel D-fused's function in plain PyTorch: the row quantization of
    :func:`~.quant.quantize_activations`, kernel D's dot, then ``y * sx``;
    ``w8a8_fused``'s on int8 codes."""
    xq, sx = quantize_activations(x)
    y = _act_dot(xq, packed, scales, zeros, group_size)
    return (y * sx).to(out_dtype)


w8a8_plain = w4a8_plain
w8a8_fused_plain = w4a8_fused_plain


def _fn(name):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(build.load(_SOURCES[name]), name)
    return fn


def _check_operands(name, x, packed, scales, zeros, lut, out_dtype):
    """Devices, types, shapes and contiguity the kernels take; raises on
    anything else. Returns ``(n, kw, G)``, ``kw`` the 32-bit words of a
    packed row."""
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
    dtype, per_word = ((torch.int8, 1) if name in BYTE_KERNELS
                       else (torch.int32, 8))
    kp = kw * per_word
    if packed.dtype != dtype or kp % PACK_BLOCK:
        raise ValueError(f"{name}: packed must be {dtype} [n, kp/{per_word}] "
                         f"with kp a multiple of {PACK_BLOCK}, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
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
    if x.shape[1] > kp:
        raise ValueError(f"{name}: x has k={x.shape[1]} > packed kp={kp}")
    return n, kp // (4 if name in BYTE_KERNELS else 8), G


def _sm_count(dev) -> int:
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return sms


def _split_buffers(dev, stream: int, floats: int, ints: int):
    """The tensor-core kernels' split-k scratch (at least ``floats`` f32)
    and ticket counters (at least ``ints`` int32 zeros), one pair per device
    and stream: the last split of each tile sets its counter back to 0, so
    the counters are zeroed once, and launches on one stream never
    overlap."""
    scratch, counters = _SPLIT_BUFS.get((dev, stream), (None, None))
    if scratch is None or scratch.numel() < floats:
        scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    if counters is None or counters.numel() < ints:
        counters = torch.zeros(ints, dtype=torch.int32, device=dev)
    _SPLIT_BUFS[(dev, stream)] = (scratch, counters)
    return scratch, counters


def _launch_post(name, x, packed, scales, zeros, lut, group_size, out_dtype):
    """The tensor-core kernels (:data:`POST_KERNELS`) with
    :func:`post_launch_plan`'s launch. D and ``w8a8`` take int8 x, their
    fused twins float x (bf16 or f32, f16 widened to f32 exactly), the
    others x rounded to bf16; A, B and E take a LUT."""
    n, kw, G = _check_operands(name, x, packed, scales, zeros, lut,
                               out_dtype)
    kp = kw * (4 if name in BYTE_KERNELS else 8)
    want_lut = name in LUT_KERNELS
    if (lut is not None) != want_lut or G * group_size > kp:
        raise ValueError(f"{name}: needs {'a' if want_lut else 'no'} lut and "
                         f"num_groups * group_size <= kp, got {G} x "
                         f"{group_size} > {kp}")
    m, k = x.shape
    if name in INT8_X_KERNELS:
        if x.dtype != torch.int8:
            raise ValueError(f"{name}: x must be int8, got {x.dtype}")
        xb = x.contiguous()
    elif name in FLOAT_X_KERNELS:
        if x.dtype == torch.float16:
            x = x.float()          # exact; the kernel reads bf16 or f32
        if x.dtype not in _FUSED_X_DTYPES:
            raise ValueError(f"{name}: unsupported x dtype {x.dtype}")
        xb = x.contiguous()
    else:
        xb = x.to(torch.bfloat16).contiguous()
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return y
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    tn, per, split_blocks, floats, ints = post_launch_plan(
        name, m, n, k, G, group_size, _sm_count(dev))
    scratch = counters = None
    if floats:
        scratch, counters = _split_buffers(dev, stream, floats, ints)
    per_row = lut is not None and lut.shape[0] == n and n > 1
    extra = (_FUSED_X_DTYPES[xb.dtype],) if name in FLOAT_X_KERNELS else ()
    err = _fn(name)(
        xb.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        zeros.data_ptr(), None if lut is None else lut.data_ptr(),
        y.data_ptr(), m, n, k, kw, group_size, G, 16 if per_row else 0,
        _OUT_DTYPES[out_dtype], tn, per, split_blocks,
        None if scratch is None else scratch.data_ptr(),
        None if counters is None else counters.data_ptr(), stream, *extra)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def _launch_no_lut(name, x, packed, scales, zeros, group_size, out_dtype):
    """The kernels that read no LUT: the W4A8/W8A8 kernels, ``int8_post``
    and ``int8_fused``."""
    return _launch_post(name, x, packed, scales, zeros, None, group_size,
                        out_dtype)


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
    return _dispatch("q4_lut_post", q4_lut_post_plain, _launch_post, x,
                     packed, scales, zeros, lut, group_size, out_dtype)


def q4_lut_fused(x, packed, scales, zeros, lut, group_size, out_dtype):
    """Kernel B on ``x [m, k]``; returns ``[m, n]`` of ``out_dtype``."""
    _need_group("q4_lut_fused", group_size, 8)
    return _dispatch("q4_lut_fused", q4_lut_fused_plain, _launch_post, x,
                     packed, scales, zeros, lut, group_size, out_dtype)


def q4_lut_select(x, packed, scales, zeros, lut, group_size, out_dtype):
    """Kernel E on ``x [m, k]``; returns ``[m, n]`` of ``out_dtype``."""
    _need_group("q4_lut_select", group_size, SLICE)
    return _dispatch("q4_lut_select", q4_lut_select_plain, _launch_post, x,
                     packed, scales, zeros, lut, group_size, out_dtype)


def q4_int4_magic(x, packed, scales, zeros, group_size, out_dtype):
    """Kernel C on ``x [m, k]``; returns ``[m, n]`` of ``out_dtype``."""
    _need_group("q4_int4_magic", group_size, SLICE)
    return _dispatch("q4_int4_magic", q4_int4_magic_plain, _launch_post, x,
                     packed, scales, zeros, None, group_size, out_dtype)


def w4a8(x, packed, scales, zeros, group_size, out_dtype=torch.float32):
    """Kernel D on int8 ``x [m, k]``; returns ``[m, n]`` (the caller
    multiplies by the activation scales)."""
    _need_group("w4a8", group_size, SLICE)
    return _dispatch("w4a8", w4a8_plain, _launch_no_lut, x, packed, scales,
                     zeros, group_size, out_dtype)


def w4a8_fused(x, packed, scales, zeros, group_size, out_dtype):
    """Kernel D-fused on float ``x [m, k]``; returns ``[m, n]``."""
    _need_group("w4a8_fused", group_size, SLICE)
    return _dispatch("w4a8_fused", w4a8_fused_plain, _launch_no_lut, x,
                     packed, scales, zeros, group_size, out_dtype)


def w8a8(x, packed, scales, zeros, group_size, out_dtype=torch.float32):
    """``w8a8`` on int8 ``x [m, k]`` and int8 codes; returns ``[m, n]`` (the
    caller multiplies by the activation scales)."""
    _need_group("w8a8", group_size, SLICE)
    return _dispatch("w8a8", w8a8_plain, _launch_no_lut, x, packed, scales,
                     zeros, group_size, out_dtype)


def w8a8_fused(x, packed, scales, zeros, group_size, out_dtype):
    """``w8a8_fused`` on float ``x [m, k]`` and int8 codes; returns
    ``[m, n]``."""
    _need_group("w8a8_fused", group_size, SLICE)
    return _dispatch("w8a8_fused", w8a8_fused_plain, _launch_no_lut, x,
                     packed, scales, zeros, group_size, out_dtype)


def int8_post(x, packed, scales, zeros, group_size, out_dtype):
    """``int8_post`` on ``x [m, k]`` and int8 codes; returns ``[m, n]``."""
    _need_group("int8_post", group_size, SLICE)
    return _dispatch("int8_post", int8_post_plain, _launch_no_lut, x, packed,
                     scales, zeros, group_size, out_dtype)


def int8_fused(x, packed, scales, zeros, group_size, out_dtype):
    """``int8_fused`` on ``x [m, k]`` and int8 codes; returns ``[m, n]``.
    Group sizes of 16 or more that divide 128 or are multiples of it."""
    if group_size < 16 or (SLICE % group_size and group_size % SLICE):
        raise ValueError(f"int8_fused needs a group_size >= 16 that divides "
                         f"{SLICE} or is a multiple of it, got {group_size}")
    return _dispatch("int8_fused", int8_fused_plain, _launch_no_lut, x, packed,
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
    - ``w8a8``/``w8a8q``/``w8a8t``/``w8a8g``: :func:`w8a8` for int8 x,
      :func:`w8a8_fused` for float x (at most :data:`FUSED_ACT_M_MAX`
      rows);
    - ``int8q``/``int8t``/``int8g``: :func:`int8_post`;
    - ``int8`` (row layout): :func:`int8_fused`;
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
    elif fmt in ("w4a8", "w8a8", "w8a8q", "w8a8t", "w8a8g"):
        ext, fused = (w4a8, w4a8_fused) if fmt == "w4a8" \
            else (w8a8, w8a8_fused)
        if x2.dtype == torch.int8:
            y = ext(x2, packed, scales, zeros, g, out_dtype)
        else:
            if x2.shape[0] > FUSED_ACT_M_MAX:
                raise ValueError(
                    f"{fmt} quantizes activations in the kernel only up to "
                    f"m={FUSED_ACT_M_MAX}; quantize them first "
                    f"(quantize_activations) for m={x2.shape[0]}")
            y = fused(x2, packed, scales, zeros, g, out_dtype)
    elif fmt in ("int8q", "int8t", "int8g"):
        y = int8_post(x2, packed, scales, zeros, g, out_dtype)
    elif fmt == "int8":
        y = int8_fused(x2, packed, scales, zeros, g, out_dtype)
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
        raise ValueError(f"unknown kernel format {fmt!r}")
    return y.reshape(*lead, packed.shape[0])
