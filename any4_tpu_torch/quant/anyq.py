"""any4 quantization: per-row learned 16-entry LUTs over group-normalized
weights (counterpart of ``any4_tpu/quant/anyq.py``).

W is group-normalized into the ``[0, 2^n - 1]`` domain, each row is
clustered by weighted k-means (:mod:`.kmeans`), and the result is integer
codes, a per-row LUT and the group scales and zeros. Reconstruction is
``(lut[row, code] - 2^(n-1)) * scale + zero``.

Options: ``sample_weight`` (per-input-feature activation magnitudes),
``scale_sample_weight`` (multiply by the group scale, so that k-means
minimizes the de-normalized error), ``abs_weight_sample_weight`` (multiply
by ``|W|``), ``bias_pow`` (signed-power emphasis of extreme values),
``keep_outliers`` (pin the extreme centroids to the row min and max),
``per_row=False`` (one global LUT), ``surrogate_cluster``,
``scale_only`` (symmetric grouping), ``cluster_backend="agglomerative"``
(Ward clustering per row on the host) and ``nnq`` (the LUT refined by
gradient descent, :mod:`.nnq`, with ``nnq_args`` and
``sample_activations``).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..ops.quant import anyq_dequantize, group_codes_float
from . import kmeans as _kmeans
from . import nnq as _nnq


def _expand_groups(x: torch.Tensor, k: int, group_size: int) -> torch.Tensor:
    """[n, k/g] -> [n, k] by repeating each group value."""
    return torch.repeat_interleave(x, group_size, dim=1)[:, :k]


def _broadcast_rows(sw: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    if sw is None:
        return torch.ones(shape, dtype=torch.float32, device=device)
    return (sw if sw.ndim == 2 else sw[None, :]).expand(shape)


def any4_quantize(
    w: torch.Tensor,
    n_bit: int = 4,
    group_size: int = 128,
    per_row: bool = True,
    sample_weight: Optional[Union[torch.Tensor, np.ndarray, str]] = None,
    scale_sample_weight: bool = False,
    abs_weight_sample_weight: bool = False,
    bias_pow: float = 1.0,
    keep_outliers: bool = False,
    surrogate_cluster: bool = False,
    init: str = "k-means++",
    cluster_backend: str = "kmeans",
    kmeans_iters: int = 30,
    n_init: int = 1,
    row_chunk: Optional[int] = None,
    seed: int = 0,
    nnq: bool = False,
    nnq_args: Optional[dict] = None,
    sample_activations=None,
    scale_only: bool = False,
):
    """Quantize a weight matrix ``[n, k]`` to any4, on ``w``'s device.

    Returns ``(codes uint8 [n, k], lut f32 [n, 16] (or [1, 16] if not
    per_row) in the [0, 2^n-1] group-normalized domain, scales f32
    [n, k/g], zeros f32 [n, k/g])``. Random inits draw from a
    ``torch.Generator`` seeded with ``seed`` on ``w``'s device.
    """
    if cluster_backend not in ("kmeans", "agglomerative"):
        raise ValueError(f"unsupported cluster_backend {cluster_backend!r}")
    if nnq and not per_row:
        raise ValueError("nnq LUT refinement requires per_row=True")
    if w.ndim != 2:
        raise ValueError(f"expected a 2-D weight, got shape {tuple(w.shape)}")
    dev = w.device
    orig_shape = tuple(w.shape)
    if group_size <= 0:
        group_size = w.shape[-1]

    wg, scales, zeros = group_codes_float(w, n_bit, group_size,
                                          symmetric=scale_only)
    if not per_row:
        # one global LUT: the whole matrix clusters as one row
        wg = wg.reshape(1, -1)

    sw = None
    if isinstance(sample_weight, str):
        sw_np = _kmeans.build_sample_weight(np.zeros(orig_shape[-1]),
                                            sample_weight)
        sw = None if sw_np is None else torch.as_tensor(
            sw_np, dtype=torch.float32, device=dev)
    elif sample_weight is not None:
        sw = torch.as_tensor(sample_weight, dtype=torch.float32, device=dev)

    if scale_sample_weight:
        sw = _broadcast_rows(sw, orig_shape, dev) \
            * _expand_groups(scales, orig_shape[-1], group_size)
        if not per_row:
            sw = sw.reshape(1, -1)
    if abs_weight_sample_weight:
        sw = _broadcast_rows(sw, orig_shape, dev) * w.float().abs()
        if not per_row:
            sw = sw.reshape(1, -1)
    if sw is not None and sw.ndim == 1 and not per_row:
        sw = sw[None, :].expand(orig_shape).reshape(1, -1)

    x = wg
    half = ((2**n_bit) - 1) / 2.0
    if bias_pow != 1.0:
        x = x - half
        x = x.abs() ** bias_pow * torch.sign(x)

    if cluster_backend == "agglomerative":
        lut, assign = _kmeans.agglomerative_rows(
            x, n_clusters=2**n_bit, sample_weight=sw)
    else:
        surrogate = w.float().reshape(x.shape) if surrogate_cluster else None
        gen = torch.Generator(device=dev).manual_seed(seed)
        lut, assign = _kmeans.kmeans_rows(
            x, n_clusters=2**n_bit, sample_weight=sw, x_surrogate=surrogate,
            init=init, iters=kmeans_iters, generator=gen, n_init=n_init,
            row_chunk=row_chunk)

    if keep_outliers:
        # centroids are sorted ascending: first and last are the extremes
        lut = lut.clone()
        lut[:, -1] = x.amax(dim=1)
        lut[:, 0] = x.amin(dim=1)

    if bias_pow != 1.0:
        lut = lut.abs() ** (1.0 / bias_pow) * torch.sign(lut) + half

    if nnq:
        lut, assign = _nnq.learn_lut(
            w, lut, scales, zeros, group_size=group_size,
            sample_activations=sample_activations, **(nnq_args or {}))

    codes = assign.to(torch.uint8)
    if not per_row:
        codes = codes.reshape(orig_shape)
    return codes, lut, scales, zeros


def any4_reconstruct(w: torch.Tensor, **kwargs) -> torch.Tensor:
    """Quantize to any4 (:func:`any4_quantize` with ``kwargs``) and
    dequantize back in ``w``'s dtype: the reference's
    ``anyq_reconstruct_tensor``."""
    n_bit = kwargs.get("n_bit", 4)
    group_size = kwargs.get("group_size", 128)
    if group_size <= 0:
        group_size = w.shape[-1]
    codes, lut, scales, zeros = any4_quantize(w, **kwargs)
    lut = lut if lut.shape[0] == codes.shape[0] else lut[0]
    return anyq_dequantize(codes, lut, scales, zeros, n_bit=n_bit,
                           group_size=group_size).to(w.dtype)
