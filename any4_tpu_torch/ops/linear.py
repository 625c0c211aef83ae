"""Quantized tensor container and the ``linear`` dispatch (counterpart of
``any4_tpu/ops/linear.py``).

A quantized weight is a :class:`QuantizedTensor` leaf in the parameter
tree, and :func:`linear` dispatches on the leaf type: dense weights go to a
plain matmul, quantized ones to the fused kernels of :mod:`.gemv`.

Every format of the JAX package:

- ``any4`` (learned per-row LUT), ``nf4`` and ``fp4`` (global tables), and
  their ``t`` names (``any4t``, ``nf4t``, ``fp4t``); as in the JAX package,
  ``any4``/``nf4``/``fp4`` are renamed to the ``t`` formats when
  ``group_size % 128 == 0`` unless ``layout="row"``;
- ``mx4``: e2m1 codes with one e8m0 power-of-two scale a group (g=32 by
  default in ``quant_methods``), the global e2m1 table as its LUT;
- ``int4`` (uniform, no LUT), renamed to ``int4p`` when ``g % 128 == 0``,
  ``n`` is even and the layout is not ``"row"``;
- ``w4a8``: int4 weights with activations quantized per row to int8;
- the int8-weight formats: ``int8`` (weight only), ``w8a8`` (activations
  quantized per row to int8 as well) and ``any4q8`` (the any4 per-row LUT
  snapped to an int8 grid, codes materialized as int8), with the TPU
  layout names ``int8q``/``w8a8q`` (quad words), ``int8t``/``w8a8t``
  (transposed) and ``int8g``/``w8a8g``/``any4q8g`` (grouped). As in the JAX
  package, ``int8``/``w8a8``/``any4q8`` are renamed by k at ``g % 128 ==
  0`` unless ``layout="row"``: to the ``q`` names (``any4q8`` keeps its
  name) at ``k < 4096`` with ``n % 4 == 0``, else to the ``g`` names;
- ``int8p``: ``int8``'s codes, which the TPU split into nibble planes;
- the row-scale formats ``int8r``, ``w8a8r`` and ``any4q8r``: one group of
  the whole row (``group_size = k``), scales and zeros ``[1, n]``.

The name records which TPU layout a weight came from or goes back to; in
the port every name shares one Hopper layout per code width
(:mod:`.packing`). The kernels, by :func:`_kernel_fmt` and
:func:`.gemv.quantized_matmul`: kernel A for the ``t`` formats and the row
LUT formats at ``g % 128 == 0``, kernel B below that and for row-layout
``int4`` at every g, kernel C for ``int4p``, kernels D/D-fused for
``w4a8``, kernel E for the row-layout formats with ``use_gather=False``;
``w8a8``/``w8a8_fused`` for ``w8a8``/``w8a8q``/``w8a8t``/``any4q8``/
``w8a8r``/``any4q8r`` and for ``w8a8g``/``any4q8g`` up to
``_XLA_GROUPED_M_MAX`` rows, ``int8_post`` for ``int8q``/``int8t``/
``int8p``/``int8r`` and for ``int8g`` up to that many rows, and
``int8_fused`` for ``int8``. The grouped formats dequantize above it. The
row-scale formats give the kernels one group of ``padded_k(k)``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..tracing import span
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
# Largest m of the grouped int8 formats' kernel route; above it they
# dequantize and run a float matmul. 128 is where the TPU's batched int8 dot
# lost to that; kept so that routing and launch counts match the JAX
# package, and not a Hopper measurement.
_XLA_GROUPED_M_MAX = 128


def _int8_m_tile(k: int) -> int:
    return 1024 if k <= 4096 else _INT8_M_TILE


LUT_FMTS = ("any4", "any4t", "nf4", "nf4t", "fp4", "fp4t")
TRANSPOSED_LUT_FMTS = ("any4t", "nf4t", "fp4t")
INT_FMTS = ("int4", "int4p", "w4a8")
GROUPED_FMTS = ("w8a8g", "int8g", "any4q8g")
ROWSCALE_FMTS = ("w8a8r", "int8r", "any4q8r")
INT8_FMTS = ("int8", "int8q", "int8t", "int8p", "w8a8", "w8a8q", "w8a8t",
             "any4q8") + GROUPED_FMTS + ROWSCALE_FMTS
# formats whose activations are quantized to int8: their kernels run at
# every m, as in the JAX package (the grouped ones up to _XLA_GROUPED_M_MAX)
ACT_INT8_FMTS = ("w4a8", "w8a8", "w8a8q", "w8a8t", "any4q8", "w8a8g",
                 "any4q8g", "w8a8r", "any4q8r")
FMTS = LUT_FMTS + ("mx4",) + INT_FMTS + INT8_FMTS
# formats a quantized embedding table may use: the JAX package's layouts
# of one weight row per packed row (int4p/w4a8 interleave rows in a word,
# int8p splits bytes across planes)
EMBED_FMTS = ("int4", "any4", "nf4", "fp4", "mx4", "int8", "w8a8")
# which formats take int_zeros and scale_only, after the renames (the JAX
# package's lists; the q names take neither)
_INT_ZEROS_FMTS = ("int4", "int4p", "w4a8", "int8", "int8p", "w8a8",
                   "w8a8t", "int8t", "w8a8g", "int8g")
_SCALE_ONLY_FMTS = _INT_ZEROS_FMTS + ("w8a8r", "int8r", "any4", "any4t",
                                      "any4q8", "any4q8g", "any4q8r")


@dataclass
class QuantizedTensor:
    """A quantized 2-D weight ``[n, k]`` in the port's Hopper layout.

    Fields:
      packed: ``[n, kp/8] int32`` codes, 8 consecutive k per word
              (:func:`~.packing.pack_codes`), ``kp = padded_k(k)``, for the
              4-bit formats; ``[n, kp] int8`` centered codes
              (:func:`~.packing.pack_codes8`) for the int8 formats.
      scales: ``[kp/g, n] f32`` group scales (the JAX package's layout);
              ``[1, n]`` for the row-scale formats, whose one group is
              the row (``group_size = k``).
      zeros:  as ``scales``, the group zeros (0 for the absmax formats).
      lut:    ``[n, 16]`` per-row or ``[1, 16]`` global f32 table, centered
              (any4 stores ``lut - 8``), or None for the integer formats.
              Always row-oriented here, whatever the format name; the JAX
              package keeps ``any4t``'s as ``[16, n]``.
    Reconstruction: ``lut[row, code] * scale + zero``, ``(code - 8) * scale
    + zero`` without a LUT, ``q * scale + zero`` for int8 codes ``q``.

    ``row_shards = S > 1``: ``packed`` and the group arrays hold S k
    segments of ``k/S``, each padded on its own (:mod:`.packing`), so that
    row-parallel tensor parallelism gives each rank whole segments
    (:mod:`any4_tpu_torch.parallel.tp`); a row-scale weight's ``[1, n]``
    scales and zeros serve every segment.
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
        raise ValueError(f"unsupported fmt {fmt!r}")


# weight format -> kernel format, where they differ whatever the LUT
_KERNEL_FMTS = {"nf4": "lut4", "fp4": "lut4", "mx4": "lut4", "nf4t": "lut4t",
                "fp4t": "lut4t", "any4q8": "w8a8q", "any4q8g": "w8a8g",
                "int8p": "int8q", "int8r": "int8q", "w8a8r": "w8a8",
                "any4q8r": "w8a8"}


def _kernel_fmt(fmt: str, lut: Optional[torch.Tensor] = None) -> str:
    """The kernel format of a weight format: ``lut4``/``lut4t`` for a
    global table, ``w8a8q``/``w8a8g`` for ``any4q8``/``any4q8g`` (whose LUT
    became int8 codes at pack time), as the JAX package names them; the
    port's int8 layout also runs ``int8p`` and ``int8r`` as ``int8q`` and
    ``w8a8r``/``any4q8r`` as ``w8a8``; the format itself otherwise."""
    if fmt in ("any4", "any4t") and lut is not None and lut.shape[0] == 1:
        return "lut4" if fmt == "any4" else "lut4t"
    return _KERNEL_FMTS.get(fmt, fmt)


def _kernel_group(w: "QuantizedTensor") -> int:
    """The group size the kernels get: a row-scale weight's one group is
    its padded row, ``padded_k(k)`` (a multiple of 128; the padded codes
    are 0, so the dot does not move), all its segments when it is
    row-sharded."""
    if w.fmt in ROWSCALE_FMTS:
        return w.packed.shape[1]
    return w.group_size


def _shard_align_x(x: torch.Tensor, w: "QuantizedTensor") -> torch.Tensor:
    """``x [..., k]`` laid out as a row-sharded weight's codes are: cut at
    the segment boundaries and each segment zero-padded to
    ``padded_k(k/S)``, so that the unsharded S-segment weight runs on the
    full x. Unchanged for ``row_shards == 1``."""
    S = w.row_shards
    if S == 1:
        return x
    kl = w.shape[1] // S
    xs = x.reshape(*x.shape[:-1], S, kl)
    xs = torch.nn.functional.pad(xs, (0, packing.padded_k(kl) - kl))
    return xs.reshape(*x.shape[:-1], S * xs.shape[-1])


def quantize_tensor(w: torch.Tensor, fmt: str = "any4", group_size: int = 128,
                    row_shards: int = 1, **kwargs) -> QuantizedTensor:
    """Quantize a 2-D weight ``[n, k]`` on its own device.

    ``kwargs`` go to the any4 learner for the any4 formats, ``any4q8`` and
    ``any4q8r`` (sample_weight, init, kmeans_iters, keep_outliers, ...) and
    are not read by the others; ``layout="row"`` keeps the ``any4``/
    ``nf4``/``fp4``/``int4``/``int8``/``w8a8``/``any4q8`` name at ``g %
    128 == 0``. ``scale_only`` (symmetric) and ``int_zeros`` (integer zero
    points) apply to the formats the JAX package takes them for, after its
    renames. The row-scale formats ignore ``group_size``: their group is
    the row.

    ``row_shards`` packs k as that many segments, each padded on its own,
    for row-parallel tensor parallelism; the numbers are those of the whole
    row (groups, LUTs and row scales are learned over all of k). ``int8p``
    takes none, as in the JAX package.

    A numpy ``w`` is quantized on the host: ``int4``/``int4p`` without
    ``scale_only`` or ``int_zeros``, at ``k % group_size == 0``, through the
    C++ data plane (:mod:`any4_tpu_torch.native`) where a compiler is found,
    with the torch path's bits; every other case as a CPU tensor.
    """
    from ..quant import anyq  # anyq imports this package's ops

    layout = kwargs.pop("layout", None)
    if layout not in (None, "row", "transposed"):
        raise ValueError(f"layout must be None/'row'/'transposed', got "
                         f"{layout!r}")
    _check_fmt(fmt)
    host = w if isinstance(w, np.ndarray) else None
    if host is not None:
        w = torch.from_numpy(np.ascontiguousarray(host))
    n, k = w.shape
    if row_shards < 1 or k % row_shards:
        raise ValueError(f"k={k} is not divisible by row_shards="
                         f"{row_shards}")
    if group_size <= 0 or group_size > k:
        group_size = k      # whole-row grouping for a layer narrower than g
    if fmt in ("int8", "w8a8", "any4q8") and layout != "row" \
            and group_size % 128 == 0:
        # the JAX package's k-dependent rename
        if k >= 4096 or n % 4:
            fmt = {"int8": "int8g", "w8a8": "w8a8g", "any4q8": "any4q8g"}[fmt]
        elif fmt != "any4q8":
            fmt += "q"
    symmetric = bool(kwargs.pop("scale_only", False))
    int_zeros = bool(kwargs.pop("int_zeros", False))
    if int_zeros and fmt not in _INT_ZEROS_FMTS:
        raise ValueError(f"int_zeros does not apply to {fmt!r}")
    if symmetric and fmt not in _SCALE_ONLY_FMTS:
        raise ValueError(f"scale_only does not apply to {fmt!r}")
    if fmt in INT_FMTS:
        return _quantize_int(w, fmt, group_size, layout, symmetric, int_zeros,
                             row_shards, host)
    if fmt in INT8_FMTS:
        return _quantize_int8(w, fmt, group_size, symmetric, int_zeros,
                              kwargs, row_shards)
    if fmt == "mx4":
        codes, exps = quant.mx4_quantize(w, group_size)
        scales = quant.mx4_scales(exps)
        lut = torch.as_tensor(get_table("mx4"), device=w.device)[None, :]
        return _packed(codes, scales, torch.zeros_like(scales), lut, fmt,
                       group_size, w.dtype, row_shards)
    base = fmt[:-1] if fmt in TRANSPOSED_LUT_FMTS else fmt
    if group_size % 128 == 0 and (fmt != base or layout != "row"):
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
                   w.dtype, row_shards)


def _packed(codes, scales, zeros, lut, fmt, group_size, dtype, row_shards=1):
    """Codes (uint8 4-bit or int8) in the Hopper layout of their width and
    the group arrays padded and transposed to ``[kp/g, n]``, each of
    ``row_shards`` k segments on its own."""
    n, k = codes.shape
    scales, zeros = packing.pad_group_arrays(scales, zeros, k, group_size,
                                             row_shards)
    pack = packing.pack_codes8 if codes.dtype == torch.int8 \
        else packing.pack_codes
    return QuantizedTensor(pack(codes, row_shards), scales.t().contiguous(),
                           zeros.t().contiguous(), lut, fmt, group_size,
                           (n, k), dtype, row_shards)


def _quantize_int(w, fmt, group_size, layout, symmetric, int_zeros,
                  row_shards=1, host=None):
    """``int4``/``int4p``/``w4a8``: uniform group quantization, no LUT. The
    format checks and the int4 -> int4p rename are the JAX package's;
    ``host`` (the numpy weight) takes the C++ data plane where
    :func:`quantize_tensor` says."""
    n, k = w.shape
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
    if host is not None and fmt != "w4a8" and k % group_size == 0 \
            and not symmetric and not int_zeros:
        from .. import native
        if native.available():
            codes, scales, zeros = native.group_quantize(
                np.asarray(host, np.float32), 4, group_size)
            scales, zeros = packing.pad_group_arrays(
                torch.from_numpy(scales), torch.from_numpy(zeros), k,
                group_size, row_shards)
            return QuantizedTensor(
                torch.from_numpy(native.pack_int4(codes, row_shards)),
                scales.t().contiguous(), zeros.t().contiguous(), None, fmt,
                group_size, (n, k), w.dtype, row_shards)
    codes, scales, zeros = quant.group_quantize(
        w, 4, group_size, symmetric=symmetric, int_zeros=int_zeros)
    return _packed(codes, scales, zeros, None, fmt, group_size, w.dtype,
                   row_shards)


def snap_lut8(lutc: torch.Tensor):
    """any4q8's snap of a centered LUT ``[n|1, 16]`` to an int8 grid:
    ``sr = max(max|lut|, 1e-12) / 127`` per row and ``lut8 = clip(round(lut
    / sr), -127, 127)``, each division rounded once (:func:`~.quant.div`).
    Returns ``(lut8 f32, sr [n|1, 1])``."""
    sr = quant.div(torch.clamp(lutc.abs().amax(dim=1, keepdim=True),
                               min=1e-12), 127.0)
    return torch.clamp(torch.round(quant.div(lutc, sr)), -127.0, 127.0), sr


def _quantize_int8(w, fmt, group_size, symmetric, int_zeros, kwargs,
                   row_shards=1):
    """The int8-weight formats: centered int8 group codes
    (:func:`~.quant.int8_quantize`), or for ``any4q8``/``any4q8g``/
    ``any4q8r`` the any4 LUT snapped to an int8 grid (:func:`snap_lut8`),
    the codes materialized as ``lut8[code]`` and ``sr`` folded into the
    group scales. The row-scale formats quantize whole rows and keep their
    ``[1, n]`` scales and zeros unpadded. The format checks are the JAX
    package's."""
    from ..quant import anyq  # anyq imports this package's ops

    n, k = w.shape
    rowscale = fmt in ROWSCALE_FMTS
    if rowscale:
        group_size = k
    elif fmt not in ("int8", "int8t", "w8a8t") and group_size % 128:
        raise ValueError(f"{fmt} requires group_size a multiple of 128, got "
                         f"{group_size}")
    if fmt in ("int8q", "w8a8q", "any4q8") and n % 4:
        raise ValueError(f"{fmt} quad packing requires n % 4 == 0, got {n}")
    if fmt == "int8p" and k % 128:
        raise ValueError(f"int8p requires k a multiple of 128, got {k}")
    if fmt == "int8p" and row_shards != 1:
        raise ValueError("int8p does not support row_shards")
    if fmt not in ("any4q8", "any4q8g", "any4q8r"):
        q, scales, zeros = quant.int8_quantize(
            w, group_size, symmetric=symmetric, int_zeros=int_zeros)
    else:
        codes, lut01, scales, zeros = anyq.any4_quantize(
            w, n_bit=4, group_size=group_size, scale_only=symmetric,
            **kwargs)
        lut8, sr = snap_lut8((lut01 - 8.0).float())
        lut8, sr = lut8.expand(n, 16), sr.expand(n, 1)   # a global LUT too
        q = torch.gather(lut8, 1, codes.long()).to(torch.int8)
        scales = scales * sr
    if rowscale:
        return QuantizedTensor(packing.pack_codes8(q, row_shards),
                               scales.t().contiguous(),
                               zeros.t().contiguous(), None, fmt, k, (n, k),
                               w.dtype, row_shards)
    return _packed(q, scales, zeros, None, fmt, group_size, w.dtype,
                   row_shards)


def dequantize_tensor(qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """Reconstruct the dense weight ``[n, k]``: ``lut[code] * s + z``,
    ``(code - 8) * s + z`` without a LUT, or ``q * s + z`` for int8 codes,
    in f32, a multiply and then an add, cast to ``dtype`` (default: the
    weight's); a row-sharded weight segment by segment."""
    n, k = qt.shape
    if qt.row_shards > 1:
        S, ks = qt.row_shards, k // qt.row_shards
        if qt.fmt in ROWSCALE_FMTS:    # one row scale for every segment
            groups = [(qt.scales, qt.zeros)] * S
        else:
            groups = zip(packing.segments(qt.scales, S, axis=0),
                         packing.segments(qt.zeros, S, axis=0))
        return torch.cat([dequantize_tensor(replace(
            qt, packed=p, scales=s, zeros=z, shape=(n, ks), row_shards=1,
            group_size=ks if qt.fmt in ROWSCALE_FMTS else qt.group_size),
            dtype) for p, (s, z) in zip(packing.segments(qt.packed, S),
                                        groups)], dim=1)
    if qt.packed.dtype == torch.int8:
        q = qt.packed.float()
        kp = q.shape[1]
    else:
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


def embedding_lookup(qt: QuantizedTensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of a quantized embedding table ``[vocab, d]``: the
    codes, the scale and zero columns and the per-row LUT rows are gathered,
    then reconstructed as :func:`dequantize_tensor` does on the sub-table,
    in the table's dtype. Only the formats of :data:`EMBED_FMTS`, as in the
    JAX package. Returns ``[*ids.shape, d]``."""
    if qt.row_shards != 1:
        raise ValueError("embedding tables are not row-sharded")
    if qt.fmt not in EMBED_FMTS:
        raise ValueError(
            f"embedding lookup needs row-gatherable packing; fmt {qt.fmt!r} "
            f"packs multiple rows per word (use one of {EMBED_FMTS})")
    n, k = qt.shape
    flat = ids.reshape(-1).long()
    per_row = qt.lut is not None and qt.lut.shape[0] == n
    sub = replace(
        qt, packed=qt.packed[flat], scales=qt.scales[:, flat],
        zeros=qt.zeros[:, flat], lut=qt.lut[flat] if per_row else qt.lut,
        shape=(flat.shape[0], k))
    return dequantize_tensor(sub).reshape(*ids.shape, k)


def embed(w, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Token embeddings from a dense or a quantized table."""
    if isinstance(w, QuantizedTensor):
        x = embedding_lookup(w, ids)
    else:
        x = w[ids.long()]
    return x if dtype is None else x.to(dtype)


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
           fused_m_max: int = FUSED_M_MAX,
           use_gather: bool = True,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y = x @ W^T + bias`` where ``w`` is dense ``[n, k]`` or a
    :class:`QuantizedTensor`.

    The formats that quantize activations (``w4a8``, ``w8a8``/``w8a8q``/
    ``w8a8t``/``w8a8r``, ``any4q8``/``any4q8r``) run their kernel at every
    m: up to
    ``gemv.FUSED_ACT_M_MAX`` rows in one call that quantizes the activations
    itself, above that after :func:`quantize_activations`, in chunks of
    ``_int8_m_tile(k)`` rows once m exceeds ``max(fused_m_max,
    _int8_m_tile(k))``. The grouped int8 formats run their kernel after
    :func:`quantize_activations` (``w8a8g``/``any4q8g``) or on x as it comes
    (``int8g``) up to ``_XLA_GROUPED_M_MAX`` rows and dequantize above it.
    The other formats run the fused kernel for ``m <= fused_m_max`` rows in
    one call, larger ``m`` in chunks of ``fused_m_max`` rows, and
    ``fused_m_max=0`` dequantizes and runs a plain matmul.
    ``use_gather=False`` takes the select-LUT kernel for the row-layout
    4-bit formats.

    ``out_dtype`` (default: x's dtype) is the dtype of ``y``; float32 gives
    the kernels' float32 sums (and a dense matmul's, on the card) without
    the rounding to x's dtype.
    """
    with span("any4.linear"):
        m = x.numel() // x.shape[-1]
        out_dtype = out_dtype or x.dtype
        if not isinstance(w, QuantizedTensor):
            y = _matmul(x, w.to(x.dtype), out_dtype)
        elif w.fmt in GROUPED_FMTS and m > _XLA_GROUPED_M_MAX:
            y = _matmul(x, dequantize_tensor(w, dtype=x.dtype), out_dtype)
        elif w.fmt in ACT_INT8_FMTS:
            y = _act_int8_linear(_shard_align_x(x, w), w, fused_m_max,
                                 out_dtype)
        elif w.fmt == "int8g":
            y = gemv.quantized_matmul(_shard_align_x(x, w), w.packed,
                                      w.scales, w.zeros,
                                      group_size=w.group_size,
                                      out_dtype=out_dtype, fmt="int8g")
        elif fused_m_max > 0:
            kfmt = _kernel_fmt(w.fmt, w.lut)
            g = _kernel_group(w)
            # JAX's int8r multiplies bf16 x but sums x as it comes; the kernel
            # sums bf16 x, so float32 or float16 x gets the difference below
            fix = w.fmt == "int8r" and x.dtype != torch.bfloat16
            kernel_dtype = torch.float32 if fix else out_dtype

            def mm(xc):
                return gemv.quantized_matmul(xc, w.packed, w.scales, w.zeros,
                                             w.lut, group_size=g,
                                             out_dtype=kernel_dtype, fmt=kfmt,
                                             use_gather=use_gather)

            y = _chunked(mm, _shard_align_x(x, w), m, fused_m_max, fused_m_max,
                         w.shape[0])
            if fix:
                xf = x.float()
                dx = (xf - xf.to(torch.bfloat16).float()).sum(-1, keepdim=True)
                y = (y + dx * w.zeros[0]).to(out_dtype)
        else:
            y = _matmul(x, dequantize_tensor(w, dtype=x.dtype), out_dtype)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y


def _matmul(x, w, out_dtype):
    """``x @ w^T`` for ``w [n, k]`` in x's dtype, as ``out_dtype``: on the
    card a bf16/f16 product gives its float32 sums directly (``torch.mm``'s
    ``out_dtype``), elsewhere the product is cast."""
    if out_dtype == x.dtype:
        return torch.matmul(x, w.t())
    if x.is_cuda and out_dtype == torch.float32 \
            and x.dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=out_dtype)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return torch.matmul(x, w.t()).to(out_dtype)


def _chunked(mm, x, m, one_call_max, tile, n):
    """``mm(x)`` in one call for ``m <= one_call_max`` rows, else over
    chunks of ``tile`` rows, concatenated."""
    if m <= one_call_max:
        return mm(x)
    x2 = x.reshape(m, x.shape[-1])
    y = torch.cat([mm(x2[i:i + tile]) for i in range(0, m, tile)])
    return y.reshape(*x.shape[:-1], n)


def _act_int8_linear(x, w, fused_m_max, out_dtype):
    m = x.numel() // x.shape[-1]
    kfmt = _kernel_fmt(w.fmt)
    g = _kernel_group(w)

    def mm(xc, out_dtype):
        return gemv.quantized_matmul(xc, w.packed, w.scales, w.zeros,
                                     group_size=g,
                                     out_dtype=out_dtype, fmt=kfmt)

    if m <= gemv.FUSED_ACT_M_MAX and w.fmt not in GROUPED_FMTS:
        return mm(x, out_dtype)
    xq, sx = quantize_activations(x)
    tile = _int8_m_tile(w.shape[1])
    y = _chunked(lambda xc: mm(xc, torch.float32), xq, m,
                 max(fused_m_max, tile), tile, w.shape[0])
    return (y * sx).to(out_dtype)
