"""Code layouts: the port's own Hopper layouts, one per code width, and numpy
copies of the TPU layouts used only to carry JAX tensors and checkpoints
across.

**The 4-bit Hopper layout** (:func:`pack_codes` / :func:`unpack_codes`) is
the one layout of every 4-bit format in the port, whatever TPU layout its
format name records: the LUT formats (``csrc/q4_lut_gemv.cu`` kernels A, B
and E),
uniform int4 (``int4``/``int4p``, kernel C there) and W4A8 (``w4a8``,
``csrc/w4a8_gemv.cu``). One warp per weight row reads contiguous k, so a
word of 8 consecutive k serves all of them: ``(w >> 4p) & 0x000F000F |
0x43004300`` read as two bf16 is ``128 + c`` for ``k = 8w+p`` and
``8w+p+4`` (int4), and ``w & 0x0F0F0F0F`` / ``(w >> 4) & 0x0F0F0F0F`` are
the four int8 codes of the even and of the odd k of the word (W4A8). The
TPU's pair and quad words only tiled two or four weight rows across its
lanes.

- codes ``[n, k]`` in ``[0, 15]`` become int32 words ``[n, kp/8]``, row
  major, one weight row per packed row;
- word ``w`` of a row holds the codes of **8 consecutive k**: nibble ``j``
  (bits ``4j .. 4j+3``) is the code of ``k = 8*w + j``;
- ``k`` is zero-padded to ``kp``, a multiple of ``PACK_BLOCK = 1024``: one
  warp of the kernels reads 1024 codes of a row with one 16-byte load per
  lane (4 words = 32 consecutive k per lane);
- padded codes are 0 and the padded groups' scales and zeros are 0, so a
  padded weight reconstructs to exactly 0.0 and adds nothing.

**The int8 Hopper layout** (:func:`pack_codes8`) is the one layout of all
ten int8-weight formats (``int8``/``int8q``/``int8t``/``int8g``,
``w8a8``/``w8a8q``/``w8a8t``/``w8a8g``, ``any4q8``/``any4q8g``): the
centered int8 codes ``[n, kp]``, row major, k contiguous, zero-padded to
``kp``, with the padded groups' scales and zeros 0 as above. A lane of the
kernels reads 32 consecutive k of a row as two 16-byte loads; the TPU's
quad words, transposed and grouped arrays only tiled rows or k for its
matrix unit.

``kp`` is the same padded length as the TPU layouts', so the group scales
and zeros ``[kp/g, n]`` carry across unchanged.

**Row shards.** ``shards = S > 1`` packs the k axis as S contiguous
segments of ``k/S``, each padded on its own to ``padded_k(k/S)``, in the
codes and in the group arrays, as the JAX package's ``pack_int4(codes,
shards)`` and ``pad_group_arrays`` do. A weight packed so is S row-shard
weights side by side: the slice of segments ``[s, s + S/tp)`` is itself a
weight of ``k/tp`` columns, which row-parallel tensor parallelism gives to
one rank.

**TPU layouts** (numpy only; the CUDA kernels never read them):

- :func:`unpack_int4` / :func:`pack_int4`: ``any4_tpu`` planar row layout
  ``[n, kp/8]``; within each 1024-block, nibble ``j`` of lane word ``l``
  holds ``k = block*1024 + j*128 + l``;
- :func:`unpack_int4_transposed` / :func:`pack_int4_transposed`: the
  transposed layout ``[kp/8, n]``; within each 128-wide group, word row
  ``K`` (of 16) holds in nibble ``p`` the code of ``k = g*128 + p*16 + K``;
- :func:`unpack_int4_pair` / :func:`pack_int4_pair` (``int4p``): two rows
  per word, ``[n/2, kp/4]``; bits ``4p + 16h`` of word ``[r, kb*128 + l]``
  hold row ``2r + h`` at ``k = kb*512 + p*128 + l``;
- :func:`unpack_int4_quad` / :func:`pack_int4_quad` (``w4a8``): four rows
  per word, ``[n/4, kp/2]``; bits ``8b + 4p`` of word ``[r, kb*128 + l]``
  hold row ``4r + b`` at ``k = kb*256 + p*128 + l``;
- :func:`pack_int8` / :func:`unpack_int8` (``int8``, ``w8a8``): int8
  ``[n, kp]``, the int8 Hopper layout itself;
- :func:`pack_int8_quad` / :func:`unpack_int8_quad` (``int8q``, ``w8a8q``,
  ``any4q8``): four rows per word, ``[n/4, kp]`` int32; byte ``b`` of word
  ``[r, c]`` holds row ``4r + b`` at ``k = c``;
- :func:`pack_int8_transposed` / :func:`unpack_int8_transposed`
  (``int8t``, ``w8a8t``): int8 ``[kp, n]``;
- :func:`pack_int8_grouped` / :func:`unpack_int8_grouped` (``int8g``,
  ``w8a8g``, ``any4q8g``): int8 ``[kp/128, n, 128]``, one 128-wide k slice
  per leading index;
- :func:`pack_rowscale` / :func:`unpack_rowscale` (``int8r``, ``w8a8r``,
  ``any4q8r``): int8 ``[k, n]``, unpadded;
- :func:`pack_int8_planes` / :func:`unpack_int8_planes` (``int8p``): the
  byte ``u = q + 128`` split into its low and high nibble, the two planes of
  each 128-wide k slice side by side on a doubled k axis (``[n, G, 2,
  128]``, low plane first), in the pair layout.
"""
from __future__ import annotations

import numpy as np
import torch

PACK_BLOCK = 1024     # k per padded block (one warp-wide load of a row)
CODES_PER_WORD = 8    # nibbles per int32
LANES = 128           # TPU layouts: 128-wide k planes


def padded_k(k: int) -> int:
    return -(-k // PACK_BLOCK) * PACK_BLOCK


# ---------------------------------------------------------------------------
# The Hopper layout (torch)
# ---------------------------------------------------------------------------

def segments(x, shards: int, axis: int = -1) -> list:
    """``x`` cut into ``shards`` equal contiguous pieces along ``axis`` (the
    k segments of a row-sharded weight)."""
    k = x.shape[axis]
    if shards < 1 or k % shards:
        raise ValueError(f"k={k} is not divisible by shards={shards}")
    per = k // shards
    if isinstance(x, np.ndarray):
        return np.split(x, shards, axis=axis)
    return list(torch.split(x, per, dim=axis))


def pack_codes(codes: torch.Tensor, shards: int = 1) -> torch.Tensor:
    """Codes ``[n, k]`` (values 0..15) -> int32 words ``[n, kp/8]`` with
    8 consecutive k per word, nibble ``j`` = ``k % 8``; with ``shards > 1``
    each k segment is packed and padded on its own, side by side."""
    if shards > 1:
        return torch.cat([pack_codes(c) for c in segments(codes, shards)],
                         dim=1)
    n, k = codes.shape
    kp = padded_k(k)
    c = torch.zeros((n, kp), dtype=torch.int64, device=codes.device)
    c[:, :k] = codes.to(torch.int64)
    c = c.reshape(n, kp // CODES_PER_WORD, CODES_PER_WORD)
    shifts = 4 * torch.arange(CODES_PER_WORD, device=codes.device)
    words = (c << shifts).sum(dim=-1)                  # [0, 2^32)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_codes(packed: torch.Tensor, k: int,
                 shards: int = 1) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; returns uint8 codes ``[n, k]``."""
    if shards > 1:
        return torch.cat([unpack_codes(p, k // shards)
                          for p in segments(packed, shards)], dim=1)
    n, kw = packed.shape
    shifts = 4 * torch.arange(CODES_PER_WORD, device=packed.device,
                              dtype=torch.int32)
    c = (packed[:, :, None] >> shifts) & 0xF          # [n, kw, 8]
    return c.reshape(n, kw * CODES_PER_WORD)[:, :k].to(torch.uint8)


def pack_codes8(q: torch.Tensor, shards: int = 1) -> torch.Tensor:
    """Centered int8 codes ``[n, k]`` -> int8 ``[n, kp]``, zero-padded (each
    of ``shards`` k segments on its own). The codes of an unsharded row are
    read back as ``packed[:, :k]``."""
    if shards > 1:
        return torch.cat([pack_codes8(c) for c in segments(q, shards)],
                         dim=1)
    n, k = q.shape
    out = torch.zeros((n, padded_k(k)), dtype=torch.int8, device=q.device)
    out[:, :k] = q
    return out


def pad_axis(x: torch.Tensor, axis: int, target: int,
             value=0) -> torch.Tensor:
    """Pad ``x`` with ``value`` along ``axis`` up to length ``target``."""
    cur = x.shape[axis]
    if cur == target:
        return x
    if cur > target:
        raise ValueError(f"axis {axis} has {cur} > target {target}")
    widths = [0, 0] * (x.dim() - 1 - axis % x.dim()) + [0, target - cur]
    return torch.nn.functional.pad(x, widths, value=value)


def pad_group_arrays(scales: torch.Tensor, zeros, k: int, group_size: int,
                     shards: int = 1):
    """Zero-pad per-group ``[n, k/g]`` scales and zeros (or None) to cover
    ``padded_k(k)``, so that padded weights reconstruct to 0; with ``shards
    > 1`` each k segment's groups, as :func:`pad_groups`."""
    return (pad_groups(scales, k, group_size, shards),
            None if zeros is None else pad_groups(zeros, k, group_size,
                                                  shards))


def transposed_layout(fmt: str, group_size: int) -> bool:
    """Does a LUT format take the JAX package's transposed layout? The
    per-element LUT formats at ``group_size % 128 == 0``."""
    return fmt in ("any4", "nf4", "fp4", "mx4") and group_size % LANES == 0


def pad_groups(a: torch.Tensor, k: int, group_size: int,
               shards: int = 1) -> torch.Tensor:
    """Zero-pad per-group arrays ``[n, k/g]`` to cover ``padded_k(k)``.
    With ``shards > 1`` segment ``s`` takes the groups ``[s * G, (s + 1) *
    G)``, ``G = (k / g) // shards``, padded to ``padded_k(k / shards) / g``:
    the JAX package's ``pad_group_arrays``, whose cut and per-segment group
    count these are also where ``g`` does not divide ``k / shards``."""
    if shards > 1:
        per = a.shape[1] // shards
        return torch.cat([pad_groups(a[:, s * per:(s + 1) * per],
                                     k // shards, group_size)
                          for s in range(shards)], dim=1)
    gp = padded_k(k) // group_size
    if a.shape[1] == gp:
        return a
    out = torch.zeros((a.shape[0], gp), dtype=a.dtype, device=a.device)
    out[:, :a.shape[1]] = a
    return out


# ---------------------------------------------------------------------------
# TPU layouts (numpy; import/export of JAX tensors and checkpoints only)
# ---------------------------------------------------------------------------

def _pad_np(codes: np.ndarray) -> np.ndarray:
    n, k = codes.shape
    c = np.zeros((n, padded_k(k)), np.uint32)
    c[:, :k] = codes
    return c


def _to_int32(words: np.ndarray) -> np.ndarray:
    return words.astype(np.uint32).view(np.int32)


def pack_int4(codes: np.ndarray) -> np.ndarray:
    """TPU planar row layout ``[n, kp/8]`` (``any4_tpu`` ``pack_int4``)."""
    c = _pad_np(codes)
    n, kp = c.shape
    c = c.reshape(n, kp // PACK_BLOCK, CODES_PER_WORD, LANES)
    shifts = (4 * np.arange(CODES_PER_WORD, dtype=np.uint32))[None, None, :,
                                                                None]
    words = np.bitwise_or.reduce(c << shifts, axis=2)
    return _to_int32(words.reshape(n, kp // CODES_PER_WORD))


def unpack_int4(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_int4`; uint8 codes ``[n, k]``."""
    n, kw = packed.shape
    kp = kw * CODES_PER_WORD
    words = np.asarray(packed).view(np.uint32).reshape(
        n, kp // PACK_BLOCK, 1, LANES)
    shifts = (4 * np.arange(CODES_PER_WORD, dtype=np.uint32))[None, None, :,
                                                                None]
    c = (words >> shifts) & 0xF
    return c.reshape(n, kp)[:, :k].astype(np.uint8)


def pack_int4_transposed(codes: np.ndarray) -> np.ndarray:
    """TPU transposed layout ``[kp/8, n]`` (``any4_tpu``
    ``pack_int4_transposed``)."""
    c = _pad_np(codes)
    n, kp = c.shape
    c = c.reshape(n, kp // LANES, CODES_PER_WORD, 16)    # k = g*128+p*16+K
    c = c.transpose(1, 3, 2, 0)                           # [g, K, p, n]
    shifts = (4 * np.arange(CODES_PER_WORD, dtype=np.uint32))[None, None, :,
                                                                None]
    words = np.bitwise_or.reduce(c << shifts, axis=2)    # [g, 16, n]
    return _to_int32(words.reshape(kp // CODES_PER_WORD, n))


def unpack_int4_transposed(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_int4_transposed`; uint8 codes ``[n, k]``."""
    kw, n = packed.shape
    kp = kw * CODES_PER_WORD
    words = np.asarray(packed).view(np.uint32).reshape(kp // LANES, 16, 1, n)
    shifts = (4 * np.arange(CODES_PER_WORD, dtype=np.uint32))[None, None, :,
                                                                None]
    c = (words >> shifts) & 0xF                           # [g, K, p, n]
    c = c.transpose(3, 0, 2, 1)                           # [n, g, p, K]
    return c.reshape(n, kp)[:, :k].astype(np.uint8)


# Multi-row words: ``rows`` weight rows per word, each ``bits`` wide, split
# into ``planes`` nibbles that cover consecutive 128-wide k slices.
_MULTI_ROW = {"pair": (2, 16, 4), "quad": (4, 8, 2)}    # rows, bits, planes


def _multi_shifts(kind):
    rows, bits, planes = _MULTI_ROW[kind]
    return ((bits * np.arange(rows, dtype=np.uint32))[None, :, None, None,
                                                       None]
            + (4 * np.arange(planes, dtype=np.uint32))[None, None, None, :,
                                                       None])


def _pack_multi(codes: np.ndarray, kind: str) -> np.ndarray:
    rows, _, planes = _MULTI_ROW[kind]
    n = codes.shape[0]
    if n % rows:
        raise ValueError(f"{kind} packing needs n % {rows} == 0, got {n}")
    c = _pad_np(codes)
    kp = c.shape[1]
    c = c.reshape(n // rows, rows, kp // (planes * LANES), planes, LANES)
    words = np.bitwise_or.reduce(c << _multi_shifts(kind), axis=(1, 3))
    return _to_int32(words.reshape(n // rows, kp // planes))


def _unpack_multi(packed: np.ndarray, k: int, kind: str) -> np.ndarray:
    rows, _, planes = _MULTI_ROW[kind]
    nr, kw = packed.shape
    kp = kw * planes
    words = np.asarray(packed).view(np.uint32).reshape(
        nr, 1, kp // (planes * LANES), 1, LANES)
    c = (words >> _multi_shifts(kind)) & 0xF           # [n/r, r, kb, p, 128]
    return c.reshape(nr * rows, kp)[:, :k].astype(np.uint8)


def pack_int4_pair(codes: np.ndarray) -> np.ndarray:
    """TPU pair layout ``[n/2, kp/4]`` (``any4_tpu`` ``pack_int4_pair``)."""
    return _pack_multi(codes, "pair")


def unpack_int4_pair(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_int4_pair`; uint8 codes ``[n, k]``."""
    return _unpack_multi(packed, k, "pair")


def pack_int4_quad(codes: np.ndarray) -> np.ndarray:
    """TPU quad layout ``[n/4, kp/2]`` (``any4_tpu`` ``pack_int4_quad``)."""
    return _pack_multi(codes, "quad")


def unpack_int4_quad(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_int4_quad`; uint8 codes ``[n, k]``."""
    return _unpack_multi(packed, k, "quad")


def pack_int8(q: np.ndarray) -> np.ndarray:
    """TPU row layout ``[n, kp]`` int8 (``any4_tpu`` ``pack_int8``)."""
    n, k = q.shape
    out = np.zeros((n, padded_k(k)), np.int8)
    out[:, :k] = q
    return out


def unpack_int8(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_int8`; int8 codes ``[n, k]``."""
    return np.ascontiguousarray(np.asarray(packed)[:, :k])


def pack_int8_quad(q: np.ndarray) -> np.ndarray:
    """TPU quad layout ``[n/4, kp]`` int32 (``any4_tpu``
    ``pack_int8_quad``): byte ``b`` of word ``[r, c]`` is ``q[4r + b, c]``."""
    n = q.shape[0]
    if n % 4:
        raise ValueError(f"quad packing needs n % 4 == 0, got {n}")
    u = pack_int8(q).view(np.uint8).astype(np.uint32)
    u = u.reshape(n // 4, 4, -1)
    shifts = (8 * np.arange(4, dtype=np.uint32))[None, :, None]
    return _to_int32(np.bitwise_or.reduce(u << shifts, axis=1))


def unpack_int8_quad(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_int8_quad`; int8 codes ``[n, k]``."""
    nq, kp = packed.shape
    words = np.asarray(packed).view(np.uint32)[:, None, :]
    shifts = (8 * np.arange(4, dtype=np.uint32))[None, :, None]
    u = ((words >> shifts) & 0xFF).astype(np.uint8)      # [n/4, 4, kp]
    return np.ascontiguousarray(u.reshape(nq * 4, kp)[:, :k].view(np.int8))


def pack_int8_transposed(q: np.ndarray) -> np.ndarray:
    """TPU transposed layout ``[kp, n]`` int8 (``any4_tpu``
    ``pack_int8_transposed``)."""
    return np.ascontiguousarray(pack_int8(q).T)


def unpack_int8_transposed(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_int8_transposed`; int8 codes ``[n, k]``."""
    return np.ascontiguousarray(np.asarray(packed)[:k].T)


def pack_int8_grouped(q: np.ndarray) -> np.ndarray:
    """TPU grouped layout ``[kp/128, n, 128]`` int8 (``any4_tpu``
    ``pack_int8_grouped``)."""
    n = q.shape[0]
    return np.ascontiguousarray(
        pack_int8(q).reshape(n, -1, LANES).transpose(1, 0, 2))


def unpack_int8_grouped(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_int8_grouped`; int8 codes ``[n, k]``."""
    G, n, lanes = packed.shape
    return np.ascontiguousarray(
        np.asarray(packed).transpose(1, 0, 2).reshape(n, G * lanes)[:, :k])


def pack_rowscale(q: np.ndarray) -> np.ndarray:
    """TPU row-scale layout ``[k, n]`` int8, unpadded (``any4_tpu``
    ``pack_rowscale``)."""
    return np.ascontiguousarray(np.asarray(q, np.int8).T)


def unpack_rowscale(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_rowscale`; int8 codes ``[n, k]``."""
    return np.ascontiguousarray(np.asarray(packed)[:k].T)


def pack_int8_planes(q: np.ndarray) -> np.ndarray:
    """int8p's split bytes: ``u = q + 128`` as nibble planes ``[n, G, 2,
    128]`` (low, high) on a doubled k axis, in the pair layout ``[n/2,
    padded_k(2k)/4]``. ``k`` must be a multiple of 128."""
    n, k = q.shape
    u = (np.asarray(q, np.int32) + 128).astype(np.uint8).reshape(
        n, k // LANES, 1, LANES)
    c4 = np.concatenate([u & 0xF, u >> 4], axis=2)
    return pack_int4_pair(c4.reshape(n, 2 * k))


def unpack_int8_planes(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_int8_planes`; int8 codes ``[n, k]``."""
    c4 = unpack_int4_pair(packed, 2 * k).astype(np.int32)
    n = c4.shape[0]
    c4 = c4.reshape(n, k // LANES, 2, LANES)
    u = c4[:, :, 0] + 16 * c4[:, :, 1]
    return (u - 128).astype(np.int8).reshape(n, k)
