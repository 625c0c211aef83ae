"""Projection fusion (counterpart of ``any4_tpu/models/fuse.py``): merge
{q, k, v} into ``qkv_proj`` and {gate, up} into ``gateup_proj``.

A decode step launches one kernel per linear; with the projections fused a
Llama layer launches 4 instead of 7, each on a wider n. Works on dense
weights and on :class:`~any4_tpu_torch.ops.linear.QuantizedTensor` leaves:
in the port every layout carries n on axis 0 of ``packed`` and of a per-row
``lut`` and on axis 1 of ``scales``/``zeros`` (the row-scale formats'
``[1, n]`` too), so the parts concatenate along n with no per-layout case.
A model can be quantized first and fused after, or the other way round.

``llama.attention``/``llama.mlp`` and the engine's decode step use
``qkv_proj``/``gateup_proj`` when present.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..ops.linear import QuantizedTensor
from ..quant.api import _copy_tree


def concat_quantized(parts: List[QuantizedTensor]) -> QuantizedTensor:
    """Concatenate quantized weights along the output dimension n. The
    parts must share format, group size, k and ``row_shards``; a global
    LUT is the first part's."""
    first = parts[0]
    for p in parts[1:]:
        if (p.fmt, p.group_size, p.shape[1], p.row_shards) != (
                first.fmt, first.group_size, first.shape[1],
                first.row_shards):
            raise ValueError(
                f"fused projections must share format, group size, k and "
                f"row_shards: {(p.fmt, p.group_size, p.shape[1])} != "
                f"{(first.fmt, first.group_size, first.shape[1])}")
    lut = first.lut
    if lut is not None and lut.shape[0] == first.shape[0]:    # per row
        lut = torch.cat([p.lut for p in parts])
    return QuantizedTensor(
        torch.cat([p.packed for p in parts]),
        torch.cat([p.scales for p in parts], dim=1),
        torch.cat([p.zeros for p in parts], dim=1), lut, first.fmt,
        first.group_size, (sum(p.shape[0] for p in parts), first.shape[1]),
        first.dtype, first.row_shards)


def _concat(parts):
    if isinstance(parts[0], QuantizedTensor):
        return concat_quantized(parts)
    return torch.cat(parts)


def stack_experts(params: Dict) -> Dict:
    """Stack every MoE layer's dense experts into two weights, so the routed
    FFN runs as two matmuls a layer: ``moe_w13 = [w1_e; w3_e]`` over the
    experts ``[E*2f, d]`` (or their ``w13``) and ``moe_w2`` the experts'
    ``w2`` side by side on k, ``[d, E*f]``. The routed combine is linear in
    the experts, so the gates fold into ``moe_w2``'s input segments. Apply
    before quantization. Returns a new tree."""
    out = _copy_tree(params)
    for layer in out.get("layers", []):
        experts = layer.pop("experts", None)
        if not experts:
            continue
        w13 = [e["w13"] if "w13" in e else torch.cat([e["w1"], e["w3"]])
               for e in experts]
        layer["moe_w13"] = torch.cat(w13)
        layer["moe_w2"] = torch.cat([e["w2"] for e in experts], dim=1)
    return out


def fuse_projections(params: Dict) -> Dict:
    """A new tree with each layer's q/k/v fused into ``qkv_proj`` and
    gate/up into ``gateup_proj`` (layers without them are left as they
    are), and each MoE expert's w1/w3 into ``w13``. A partial bias set
    (say k and v only) fuses with zeros for the missing parts."""
    out = _copy_tree(params)
    for layer in out.get("layers", []):
        if all(k in layer for k in ("q_proj", "k_proj", "v_proj")):
            parts = [layer.pop("q_proj"), layer.pop("k_proj"),
                     layer.pop("v_proj")]
            layer["qkv_proj"] = _concat(parts)
            biases = [layer.pop(b, None)
                      for b in ("q_bias", "k_bias", "v_bias")]
            if any(b is not None for b in biases):
                like = next(b for b in biases if b is not None)
                layer["qkv_bias"] = torch.cat([
                    torch.zeros(p.shape[0], dtype=like.dtype,
                                device=like.device) if b is None else b
                    for b, p in zip(biases, parts)])
        if all(k in layer for k in ("gate_proj", "up_proj")):
            layer["gateup_proj"] = _concat(
                [layer.pop("gate_proj"), layer.pop("up_proj")])
        for expert in layer.get("experts", []):
            if all(k in expert for k in ("w1", "w3")):
                expert["w13"] = _concat([expert.pop("w1"), expert.pop("w3")])
    return out
