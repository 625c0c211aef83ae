"""Model quantization over a parameter tree (counterpart of
``any4_tpu/quant/api.py``).

A model is a parameter tree of dicts and lists; quantization replaces every
targeted 2-D linear weight with a
:class:`~any4_tpu_torch.ops.linear.QuantizedTensor` (or, with
``pseudo=True``, with its dense reconstruction). The LM head is skipped by
default, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..ops import linear as lin
from . import kmeans

DEFAULT_LINEAR_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
    "qkv_proj", "gateup_proj",
    "fc1", "fc2", "out_proj", "lm_head",
    "w1", "w2", "w3", "w13", "moe_w13", "moe_w2", "wq", "wk", "wv", "wo",
)
DEFAULT_SKIP = ("lm_head",)
# leaves whose input (k) dim is split under tensor parallelism: with
# ``row_parallel_shards`` these pack k as independently padded segments
ROW_PARALLEL_KEYS = ("o_proj", "down_proj", "fc2", "w2", "wo", "out_proj")
LEARNED_FMTS = ("any4", "any4t", "anyq", "any4q8", "any4q8g", "any4q8r")
_LEARNER_KWARGS = ("sample_weight", "init", "keep_outliers",
                   "scale_sample_weight", "abs_weight_sample_weight",
                   "bias_pow", "kmeans_iters", "seed", "per_row",
                   "surrogate_cluster")
# the learner options that quantize_embeddings passes on to an any4 table
_EMBED_KWARGS = ("kmeans_iters", "init", "keep_outliers", "per_row",
                 "row_chunk")


def _walk(tree: Any, prefix: str = ""):
    """Yield ``(name, leaf, setter)`` over nested dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, child in list(items):
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(child, (dict, list)):
            yield from _walk(child, name)
        else:
            def setter(value, parent=tree, key=key):
                parent[key] = value
            yield name, child, setter


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def default_layer_filter(name: str, leaf: Any) -> bool:
    return (isinstance(leaf, (torch.Tensor, np.ndarray)) and leaf.ndim == 2
            and name.split(".")[-1] in DEFAULT_LINEAR_KEYS)


def quantize_model(
    params: Dict,
    fmt: str = "any4",
    group_size: int = 128,
    skip_modules: Union[str, Sequence[str]] = DEFAULT_SKIP,
    layer_filter: Callable[[str, Any], bool] = default_layer_filter,
    pseudo: bool = False,
    sample_weight: Union[None, Dict, Callable, torch.Tensor] = None,
    calibrate_fn: Optional[Callable] = None,
    progress: bool = False,
    row_parallel_shards: int = 1,
    quantize_embeddings: Union[bool, str, None] = None,
    device="cuda",
    **kwargs,
) -> Dict:
    """Quantize every targeted linear weight of a parameter tree on
    ``device``; returns a new tree (the input is not modified).

    - ``skip_modules``: leaf names (last path component or full dotted
      path) left dense; the LM head by default.
    - ``pseudo``: store the dequantized reconstruction as a dense tensor.
    - ``sample_weight``: ``{layer_name: [k]}``, one ``[k]`` tensor, or a
      callable ``f(name) -> [k]``.
    - ``calibrate_fn``: per-layer online calibration; it is called as
      ``calibrate_fn(layers=[name], seed=index)`` for each layer, and what
      it returns takes ``sample_weight``'s place
      (:func:`~any4_tpu_torch.calibrate.make_calibrate_fn` makes one).
    - Learned formats get ``seed=index`` (the layer's position) unless a
      seed is given; other kwargs flow to
      :func:`~any4_tpu_torch.ops.linear.quantize_tensor`.
    - If a layer runs out of device memory while clustering, it is retried
      once with a chunk budget 16 times smaller.
    - ``row_parallel_shards``: the leaves of :data:`ROW_PARALLEL_KEYS` pack
      k as that many independently padded segments, so that row-parallel
      tensor parallelism gives each rank whole segments
      (:mod:`any4_tpu_torch.parallel.tp`).
    - A numpy leaf is quantized on the host
      (:func:`~any4_tpu_torch.ops.linear.quantize_tensor`) when ``device``
      is the CPU, and moved to ``device`` otherwise.
    - ``quantize_embeddings``: also quantize every ``embed_tokens`` table in
      the row layout, to ``fmt`` (``True``) or to the format named
      (``"anyq"``: any4, ``"intq"``: int4), one of
      :data:`~any4_tpu_torch.ops.linear.EMBED_FMTS`. An any4 table gets only
      the learner options ``kmeans_iters``, ``init``, ``keep_outliers``,
      ``per_row`` and ``row_chunk``, and the learner's default seed. A tied
      head then runs the quantized kernel on the same table.
    """
    efmt = None
    if quantize_embeddings:
        efmt = fmt if quantize_embeddings is True else str(quantize_embeddings)
        efmt = {"anyq": "any4", "intq": "int4"}.get(efmt, efmt)
        if efmt not in lin.EMBED_FMTS:
            raise ValueError(f"quantize_embeddings needs a row-gatherable "
                             f"packing, one of {lin.EMBED_FMTS}; got "
                             f"{efmt!r}")
    if isinstance(skip_modules, str):
        skip_modules = [s.strip() for s in skip_modules.split(",")]
    f = {"anyq": "any4", "intq": "int4"}.get(fmt, fmt)
    out = _copy_tree(params)
    targets = [(n, l, s) for n, l, s in _walk(out) if layer_filter(n, l)
               and n.split(".")[-1] not in skip_modules
               and n not in skip_modules]
    for index, (name, leaf, setter) in enumerate(targets):
        kw = dict(kwargs)
        sw = sample_weight
        if calibrate_fn is not None:
            sw = calibrate_fn(layers=[name], seed=index)
        if isinstance(sw, dict):
            sw = sw.get(name)
        elif callable(sw):
            sw = sw(name)
        if sw is not None:
            kw["sample_weight"] = torch.as_tensor(sw, dtype=torch.float32,
                                                  device=device)
        if fmt in LEARNED_FMTS:
            kw.setdefault("seed", index)
        else:
            for k in _LEARNER_KWARGS:
                kw.pop(k, None)
        if isinstance(leaf, np.ndarray):
            w = (leaf if torch.device(device).type == "cpu"
                 else torch.from_numpy(leaf).to(device))
        else:
            w = leaf.to(device)
        kw["row_shards"] = (row_parallel_shards if name.split(".")[-1]
                            in ROW_PARALLEL_KEYS else 1)
        try:
            qt = lin.quantize_tensor(w, f, group_size, **kw)
        except torch.OutOfMemoryError:
            if fmt not in LEARNED_FMTS:
                raise
            if progress:
                print(f"  out of memory quantizing {name}; retrying with a "
                      f"smaller k-means chunk")
            torch.cuda.empty_cache()
            rows = kmeans.CHUNK_BYTES // (w.shape[1] * 16 * 4)
            qt = lin.quantize_tensor(
                w, f, group_size, **{**kw, "row_chunk": max(1, rows // 16)})
        if progress:
            print(f"  quantized {name} {tuple(leaf.shape)} -> {qt.fmt}")
        setter(lin.dequantize_tensor(qt, dtype=qt.dtype) if pseudo else qt)
    if efmt is not None:
        ekw = ({k: v for k, v in kwargs.items() if k in _EMBED_KWARGS}
               if efmt == "any4" else {})
        for name, leaf, setter in _walk(out):
            if name.split(".")[-1] != "embed_tokens" \
                    or getattr(leaf, "ndim", 0) != 2:
                continue
            qt = lin.quantize_tensor(leaf.to(device), efmt, group_size,
                                     layout="row", **ekw)
            if progress:
                print(f"  quantized {name} {tuple(leaf.shape)} -> {efmt}")
            setter(lin.dequantize_tensor(qt, dtype=leaf.dtype) if pseudo
                   else qt)
    return out


def dequantize_model(params: Dict) -> Dict:
    """Replace every QuantizedTensor leaf with its dense reconstruction."""
    out = _copy_tree(params)
    for _, leaf, setter in _walk(out):
        if isinstance(leaf, lin.QuantizedTensor):
            setter(lin.dequantize_tensor(leaf))
    return out


def model_size_bytes(params: Dict) -> int:
    total = 0
    for _, leaf, _ in _walk(params):
        if isinstance(leaf, lin.QuantizedTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


quant_methods = {
    name: functools.partial(quantize_model, fmt=name)
    for name in ("int4", "int4p", "int8", "int8p", "w4a8", "w8a8", "intq",
                 "any4", "any4t", "any4q8", "any4q8r", "w8a8r", "int8r",
                 "anyq", "nf4", "nf4t", "fp4", "fp4t")
}
quant_methods["mx4"] = functools.partial(quantize_model, fmt="mx4",
                                         group_size=32)
