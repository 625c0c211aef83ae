"""Save and load parameter trees in the JAX package's checkpoint format
(counterpart of ``any4_tpu/models/checkpoint.py``).

A checkpoint is a directory with ``params.npz`` (dotted leaf names ->
arrays, bfloat16 stored as uint16 bits) and ``meta.json`` (the dtype of
each array, the fields of each quantized weight, the model config).
Quantized weights are stored in the TPU layouts their format names, through
:mod:`any4_tpu_torch.convert`, so a checkpoint written by either package
loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np

from .. import convert
from . import llama


def save_params(path: str, params: Dict, cfg=None) -> None:
    os.makedirs(path, exist_ok=True)
    arrays, dtypes, qt_meta = {}, {}, {}

    def put(name, a, dtype):
        arrays[name] = a
        dtypes[name] = dtype

    tree = convert.to_jax_numpy(params)
    for name, leaf in _walk_jax(tree):
        if convert.is_jax_qt(leaf):
            for field in convert.QT_FIELDS:
                if leaf[field] is not None:
                    put(f"{name}.{field}", leaf[field], str(leaf[field].dtype))
            qt_meta[name] = {
                "fmt": leaf["fmt"], "group_size": leaf["group_size"],
                "shape": list(leaf["shape"]), "dtype": leaf["dtype"],
                "has_lut": leaf["lut"] is not None, "row_shards": 1,
            }
        elif leaf is not None:
            put(name, leaf, "bfloat16" if leaf.dtype == np.uint16
                else str(leaf.dtype))
    np.savez(os.path.join(path, "params.npz"), **arrays)
    meta = {"quantized": qt_meta, "dtypes": dtypes}
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
        meta["config"]["dtype"] = convert.dtype_name(cfg.dtype)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def _walk_jax(tree):
    """``(dotted name, leaf)`` over a numpy tree; a quantized-weight dict
    is one leaf."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, child in items:
        if isinstance(child, (dict, list)) and not convert.is_jax_qt(child):
            for name, leaf in _walk_jax(child):
                yield f"{key}.{name}", leaf
        else:
            yield str(key), child


def load_params(path: str, device="cuda") -> Tuple[Dict, "llama.LlamaConfig"]:
    """Load a checkpoint of either package onto ``device``. Returns
    ``(params, cfg)``; ``cfg`` is None when the checkpoint has none."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    qt_meta = meta.get("quantized", {})
    dtypes = meta.get("dtypes", {})
    tree: Dict = {}

    def setleaf(name, value):
        parts = name.split(".")
        node = tree
        for p, nxt in zip(parts[:-1], parts[1:]):
            key = int(p) if p.isdigit() else p
            child = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = child
            elif key not in node:
                node[key] = child
            node = node[key]
        last = int(parts[-1]) if parts[-1].isdigit() else parts[-1]
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
        node[last] = value

    with np.load(os.path.join(path, "params.npz")) as raw:
        def array(name):
            a = raw[name]
            return a.view(np.uint16) if dtypes.get(name) == "bfloat16" else a

        consumed = set()
        for qname, m in qt_meta.items():
            d = {field: array(f"{qname}.{field}")
                 for field in convert.QT_FIELDS
                 if field != "lut" or m.get("has_lut", True)}
            d.update(fmt=m["fmt"], group_size=m["group_size"],
                     shape=m["shape"], dtype=m.get("dtype", "bfloat16"),
                     row_shards=m.get("row_shards", 1))
            setleaf(qname, convert.qt_from_jax(d, device))
            consumed.update(f"{qname}.{field}" for field in convert.QT_FIELDS)
        for name in raw.files:
            if name not in consumed:
                setleaf(name, convert.tensor_from_numpy(array(name), device))

    cfg = None
    if "config" in meta:
        c = dict(meta["config"])
        c["dtype"] = convert.torch_dtype(
            "bfloat16" if "bfloat16" in str(c.get("dtype")) else "float32")
        if c.get("layer_types") is not None:
            c["layer_types"] = tuple(c["layer_types"])
        cfg = llama.LlamaConfig(**c)
    return tree, cfg
