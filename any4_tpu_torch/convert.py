"""Carry parameter trees between the JAX package and the port, through numpy.

The JAX side of a tree is numpy only, so this module needs neither JAX nor
the JAX package:

- a dense leaf is a numpy array; bfloat16 travels as its raw bits in a
  ``uint16`` array (as ``any4_tpu/models/checkpoint.py`` stores it), and an
  array whose dtype is named ``bfloat16`` is read the same way;
- a JAX ``QuantizedTensor`` is a dict of its numpy fields (``packed``,
  ``scales``, ``zeros``, ``lut``; ``lut`` is None for the integer formats)
  plus ``fmt``, ``group_size``, ``shape`` and optionally ``dtype`` and
  ``row_shards``.

Quantized weights are unpacked from their TPU layout to codes and repacked
in the port's layout (:mod:`any4_tpu_torch.ops.packing`); the scales and
zeros ``[kp/g, n]`` are the same arrays in both packages, and the LUT is
turned to ``[n, 16]``/``[1, 16]``. The TPU layouts: planar ``[n, kp/8]``
for ``any4``/``nf4``/``fp4``/``mx4``/``int4``, transposed ``[kp/8, n]`` for
``any4t``/``nf4t``/``fp4t``, pair words for ``int4p`` and quad words for
``w4a8``; for the int8 formats row ``[n, kp]`` (``int8``/``w8a8``), quad
words ``[n/4, kp]`` (``int8q``/``w8a8q``/``any4q8``), transposed ``[kp,
n]`` (``int8t``/``w8a8t``), grouped ``[kp/128, n, 128]``
(``int8g``/``w8a8g``/``any4q8g``), ``[k, n]`` with ``[1, n]`` scales and
zeros for the row-scale formats (``int8r``/``w8a8r``/``any4q8r``), and
int8p's nibble planes (:func:`int8p_groups_from_jax`). Each format name
selects its layout from an explicit table: ``int8t`` and ``w8a8t`` end in
``t`` but have no LUT.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .ops import packing
from .ops.linear import (FMTS, ROWSCALE_FMTS, TRANSPOSED_LUT_FMTS,
                         QuantizedTensor)

QT_FIELDS = ("packed", "scales", "zeros", "lut")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def is_jax_qt(node: Any) -> bool:
    return isinstance(node, dict) and "packed" in node and "fmt" in node


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[str(name).replace("torch.", "")]


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """A numpy leaf as a tensor; uint16 (or a numpy bfloat16) is bf16."""
    a = np.array(a)     # a writable, contiguous copy
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 as its raw bits in a uint16 array."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _check_fmt(fmt: str, row_shards: int) -> None:
    if row_shards != 1:
        raise NotImplementedError(
            "row_shards != 1 weights are not ported yet (ROADMAP queue 1, "
            "item 12)")
    if fmt not in FMTS:
        raise ValueError(f"unsupported fmt {fmt!r}")


# format -> (unpack, pack) of its TPU layout, besides the 4-bit planar one
_TPU_LAYOUTS = {
    "int4p": (packing.unpack_int4_pair, packing.pack_int4_pair),
    "w4a8": (packing.unpack_int4_quad, packing.pack_int4_quad),
    **{f: (packing.unpack_int4_transposed, packing.pack_int4_transposed)
       for f in TRANSPOSED_LUT_FMTS},
    **{f: (packing.unpack_int8, packing.pack_int8)
       for f in ("int8", "w8a8")},
    **{f: (packing.unpack_int8_quad, packing.pack_int8_quad)
       for f in ("int8q", "w8a8q", "any4q8")},
    **{f: (packing.unpack_int8_transposed, packing.pack_int8_transposed)
       for f in ("int8t", "w8a8t")},
    **{f: (packing.unpack_int8_grouped, packing.pack_int8_grouped)
       for f in ("int8g", "w8a8g", "any4q8g")},
    **{f: (packing.unpack_rowscale, packing.pack_rowscale)
       for f in ROWSCALE_FMTS},
    "int8p": (packing.unpack_int8_planes, packing.pack_int8_planes),
}
_PLANAR = (packing.unpack_int4, packing.pack_int4)


def int8p_groups_from_jax(s4: np.ndarray, z4: np.ndarray, k: int,
                          group_size: int):
    """int8p's per-plane rows -> the port's ``[kp/g, n]`` scales and zeros.

    The JAX package stores, for each 128-wide k slice, a row for the low
    nibble plane (``s``, ``z - 120 s``) and one for the high (``16 s``,
    ``128 s``), padded to ``padded_k(2 k) / 128`` rows. ``s`` is the low
    plane's scale of every ``g / 128``-th slice and ``z = (z - 120 s) + 120
    s``: that sum may land up to an ulp of ``120 s`` off the zero
    ``int8_quantize`` gave, and is the zero the JAX package's own
    ``dequantize_tensor`` uses."""
    step = group_size // packing.LANES
    s = s4[0::2][:k // packing.LANES][::step]
    z = z4[0::2][:k // packing.LANES][::step] + np.float32(120.0) * s
    gp = packing.padded_k(k) // group_size
    pad = ((0, gp - s.shape[0]), (0, 0))
    return np.pad(s, pad), np.pad(z, pad)


def int8p_groups_to_jax(s: np.ndarray, z: np.ndarray, k: int,
                        group_size: int):
    """Inverse of :func:`int8p_groups_from_jax`, as the JAX package's
    ``quantize_tensor(fmt="int8p")`` derives the plane rows."""
    step = group_size // packing.LANES
    s128 = np.repeat(s[:k // group_size], step, axis=0)
    z128 = np.repeat(z[:k // group_size], step, axis=0)
    n = s.shape[1]
    s4 = np.stack([s128, np.float32(16.0) * s128], axis=1).reshape(-1, n)
    z4 = np.stack([z128 - np.float32(120.0) * s128,
                   np.float32(128.0) * s128], axis=1).reshape(-1, n)
    pad = ((0, packing.padded_k(2 * k) // packing.LANES - s4.shape[0]),
           (0, 0))
    return np.pad(s4, pad), np.pad(z4, pad)


def qt_from_jax(d: dict, device="cuda") -> QuantizedTensor:
    """A JAX ``QuantizedTensor`` (as a dict of numpy fields) in the port's
    layout."""
    fmt = d["fmt"]
    _check_fmt(fmt, int(d.get("row_shards", 1)))
    n, k = (int(s) for s in d["shape"])
    lut = d.get("lut")
    lut = None if lut is None else np.asarray(lut, np.float32)
    if fmt in TRANSPOSED_LUT_FMTS:
        lut = lut.T                                   # [16, n|1] -> [n|1, 16]
    codes = torch.from_numpy(
        _TPU_LAYOUTS.get(fmt, _PLANAR)[0](np.asarray(d["packed"]), k)[:, :k]
        .copy())
    pack = packing.pack_codes8 if codes.dtype == torch.int8 \
        else packing.pack_codes
    scales = np.asarray(d["scales"], np.float32)
    zeros = np.asarray(d["zeros"], np.float32)
    if fmt == "int8p":
        scales, zeros = int8p_groups_from_jax(scales, zeros, k,
                                              int(d["group_size"]))
    f32 = (lambda a: tensor_from_numpy(np.asarray(a, np.float32), device))
    return QuantizedTensor(
        pack(codes).to(device),
        f32(scales), f32(zeros), None if lut is None else f32(lut),
        fmt, int(d["group_size"]), (n, k),
        torch_dtype(d.get("dtype", "bfloat16")), 1)


def qt_to_jax(qt: QuantizedTensor) -> dict:
    """The port's ``QuantizedTensor`` as the JAX package's fields (numpy),
    in the TPU layout its format names."""
    _check_fmt(qt.fmt, qt.row_shards)
    n, k = qt.shape
    packed = qt.packed.detach().cpu()
    codes = (packed[:, :k] if packed.dtype == torch.int8
             else packing.unpack_codes(packed, k)).numpy()
    lut = None if qt.lut is None else qt.lut.detach().cpu().float().numpy()
    packed = _TPU_LAYOUTS.get(qt.fmt, _PLANAR)[1](codes)
    if qt.fmt in TRANSPOSED_LUT_FMTS:
        lut = np.ascontiguousarray(lut.T)             # [16, n|1]
    scales = qt.scales.detach().cpu().numpy()
    zeros = qt.zeros.detach().cpu().numpy()
    if qt.fmt == "int8p":
        scales, zeros = int8p_groups_to_jax(scales, zeros, k, qt.group_size)
    return {"packed": packed, "scales": scales, "zeros": zeros,
            "lut": lut, "fmt": qt.fmt, "group_size": qt.group_size,
            "shape": (n, k), "dtype": dtype_name(qt.dtype),
            "row_shards": 1}


def from_jax_params(tree: Any, device="cuda") -> Any:
    """The JAX package's parameter tree (numpy leaves, quantized weights as
    dicts) as the port's tree on ``device``."""
    if is_jax_qt(tree):
        return qt_from_jax(tree, device)
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device) for v in tree]
    if tree is None:
        return None
    return tensor_from_numpy(tree, device)


def to_jax_numpy(params: Any) -> Any:
    """Inverse of :func:`from_jax_params`: numpy leaves (bf16 as uint16),
    quantized weights as dicts of the JAX package's fields."""
    if isinstance(params, QuantizedTensor):
        return qt_to_jax(params)
    if isinstance(params, dict):
        return {k: to_jax_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [to_jax_numpy(v) for v in params]
    if params is None:
        return None
    return tensor_to_numpy(params)
