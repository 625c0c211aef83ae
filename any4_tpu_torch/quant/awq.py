"""AWQ, activation-aware pre-quantization (counterpart of
``any4_tpu/quant/awq.py``).

``run_awq`` searches, for each group of linears that share an input, a
per-input-channel scale ``s = x_max^ratio`` (``n_grid`` ratios) that
minimizes the output MSE of the pseudo-quantized group, folds ``1/s`` into
the producer (a norm, or the rows of the linear before), then searches a
per-row clip of the weights. Scaling is neutral in exact arithmetic:
``(x / s) @ (W * s)^T == x @ W^T``; it moves quantization error away from
channels with large activations.

The candidates of a search run one after another on the device, and the
host reads the argmin of their MSEs once per search (the JAX package runs
the grid as one compiled scan). Schemas, per decoder layer:

- Llama: input_layernorm -> q/k/v, v_proj -> o_proj (the scale shared by
  the query heads of a kv head under GQA), post_attention_layernorm ->
  gate/up, up_proj -> down_proj;
- OPT: self_attn_layer_norm -> q/k/v, v_proj -> out_proj (``v_bias``
  scaled with its rows), final_layer_norm -> fc1, fc1 -> fc2;
- Mixtral: the attention as Llama's, post_attention_layernorm -> every
  expert's w1/w3 and the router, each expert's w3 -> w2.

Results keep numpy arrays under the JAX package's keys, and
:func:`save_awq` writes its ``.npz`` layout, so an artifact of either
package applies in the other.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models import generate, llama, mixtral, opt
from ..ops import quant
from . import kmeans as _kmeans
from .api import _copy_tree


def pseudo_quantize(w: torch.Tensor, n_bit: int = 4, group_size: int = 128,
                    numeric_type: str = "int") -> torch.Tensor:
    """Quantize ``w`` and dequantize it back in its dtype, the objective's
    inner quantizer:

    - ``int``: uniform grouped asymmetric;
    - ``any4``/``any``: a per-row LUT in the group-normalized domain from
      k-means with the ``int`` init and 8 iterations over all rows at once
      (its ``[n, k, 16]`` f32 distances are 1 GiB at 8192 x 2048);
    - ``nf4``/``fp4``: absmax fixed-codebook rounding.
    """
    if numeric_type == "int":
        codes, scales, zeros = quant.group_quantize(w, n_bit, group_size)
        return quant.group_dequantize(codes, scales, zeros, n_bit,
                                      group_size).to(w.dtype)
    if numeric_type in ("any", "any4"):
        wg, scales, zeros = quant.group_codes_float(w, n_bit, group_size)
        lut, assign = _kmeans.kmeans_rows(
            wg, n_clusters=2 ** n_bit, init="int", iters=8,
            row_chunk=wg.shape[0])
        vals = torch.gather(lut, 1, assign.long())
        vg = vals.reshape(w.shape[0], -1, group_size) - 2 ** (n_bit - 1)
        wdeq = vg * scales[..., None] + zeros[..., None]
        return wdeq.reshape(w.shape).to(w.dtype)
    if numeric_type in ("nf4", "fp4"):
        codes, scales = quant.lut_quantize(w, fmt=numeric_type,
                                           group_size=group_size)
        return quant.lut_dequantize(codes, scales, fmt=numeric_type,
                                    group_size=group_size).to(w.dtype)
    raise ValueError(f"unsupported numeric_type {numeric_type!r}")


def _candidate_scale(x_max: torch.Tensor, ratio) -> torch.Tensor:
    """``x_max^ratio`` over its geometric mean, clipped to [1e-4, 1e4]. A
    Python ``ratio`` is made an f32 tensor first, so that the grid's and
    the winner's powers are the same operation."""
    if not isinstance(ratio, torch.Tensor):
        ratio = torch.full((), ratio, dtype=torch.float32,
                           device=x_max.device)
    s = torch.pow(x_max, ratio)
    s = s / torch.sqrt(s.max() * s.min())
    return torch.clamp(s, 1e-4, 1e4)


def _scale_search_mses(x, weights, x_max, n_grid, n_bit, group_size,
                       numeric_type) -> torch.Tensor:
    """The output MSE ``[n_grid]`` of each candidate scale, ratios
    ``arange(n_grid) / n_grid`` in f32."""
    weights = [w.float() for w in weights]
    y_ref = torch.cat([x @ w.t() for w in weights], dim=-1)
    ratios = quant.div(torch.arange(n_grid, dtype=torch.float32,
                                    device=x.device), n_grid)
    mses = []
    for ratio in ratios:
        s = _candidate_scale(x_max, ratio)[None, :]
        # one pseudo-quantized weight alive at a time
        y = torch.cat([x @ (pseudo_quantize(w * s, n_bit, group_size,
                                            numeric_type) / s).t()
                       for w in weights], dim=-1)
        mses.append(torch.mean((y - y_ref) ** 2))
    return torch.stack(mses)


def search_scale(x: torch.Tensor, weights: List[torch.Tensor],
                 n_grid: int = 20, n_bit: int = 4, group_size: int = 128,
                 numeric_type: str = "int") -> Tuple[torch.Tensor, float]:
    """Grid-search the per-channel scale ``[k]`` of a group of linears
    that share the input ``x`` ``[t, k]``. Returns ``(scales, ratio)``."""
    x = x.float()
    x_max = x.abs().mean(dim=tuple(range(x.ndim - 1))) + 1e-8
    mses = _scale_search_mses(x, weights, x_max, n_grid, n_bit, group_size,
                              numeric_type)
    ratio = int(torch.argmin(mses)) / n_grid
    return _candidate_scale(x_max, ratio), ratio


def _clip_search_mses(x, w32, n_grid, min_ratio, n_bit, group_size,
                      numeric_type) -> torch.Tensor:
    """The output MSE ``[n_grid]`` of each clip ratio ``1 - (1 -
    min_ratio) * i / n_grid``, in f32 as the JAX package computes it."""
    y_ref = x @ w32.t()
    absmax = w32.abs().amax(dim=1, keepdim=True)
    idx = np.arange(n_grid, dtype=np.float32)
    ratios = torch.from_numpy(np.float32(1.0) - np.float32(1.0 - min_ratio)
                              * idx / np.float32(n_grid)).to(x.device)
    mses = []
    for ratio in ratios:
        lim = absmax * ratio
        wq = pseudo_quantize(torch.clamp(w32, -lim, lim), n_bit, group_size,
                             numeric_type)
        mses.append(torch.mean((x @ wq.t() - y_ref) ** 2))
    return torch.stack(mses)


def search_clip(x: torch.Tensor, w: torch.Tensor, n_grid: int = 20,
                min_ratio: float = 0.5, n_bit: int = 4,
                group_size: int = 128, return_ratio: bool = False,
                numeric_type: str = "int"):
    """Grid-search a clip of each row of ``w`` to a share of its max
    magnitude that minimizes the output MSE on ``x``. Returns the clipped
    weight in ``w``'s dtype (and the ratio with ``return_ratio``)."""
    x = x.float()
    w32 = w.float()
    mses = _clip_search_mses(x, w32, n_grid, min_ratio, n_bit, group_size,
                             numeric_type)
    ratio = 1.0 - (1.0 - min_ratio) * int(torch.argmin(mses)) / n_grid
    clipped = _clip(w32, ratio).to(w.dtype)
    return (clipped, ratio) if return_ratio else clipped


def _clip(w32: torch.Tensor, ratio: float) -> torch.Tensor:
    lim = w32.abs().amax(dim=1, keepdim=True) * ratio
    return torch.clamp(w32, -lim, lim)


def _schema(layer: Dict, is_opt: bool, is_moe: bool):
    """``(groups, clip_targets)`` of a decoder layer: each group is
    ``(producer, targets, captured input name)``."""
    if is_opt:
        return ([("self_attn_layer_norm", ("q_proj", "k_proj", "v_proj"),
                  "q_proj"),
                 ("v_proj", ("out_proj",), "out_proj"),
                 ("final_layer_norm", ("fc1",), "fc1"),
                 ("fc1", ("fc2",), "fc2")],
                ("out_proj", "fc1", "fc2", "v_proj"))
    attn = [("input_layernorm", ("q_proj", "k_proj", "v_proj"), "q_proj"),
            ("v_proj", ("o_proj",), "o_proj")]
    if is_moe:
        n_exp = len(layer["experts"])
        # the router reads the experts' input: it joins their group, or the
        # norm fold would move the routing
        w13 = tuple(f"experts.{e}.{w}" for e in range(n_exp)
                    for w in ("w1", "w3")) + ("router",)
        return (attn + [("post_attention_layernorm", w13, "moe")] + [
            (f"experts.{e}.w3", (f"experts.{e}.w2",), f"experts.{e}.w2")
            for e in range(n_exp)],
            ("o_proj", "v_proj") + tuple(
                f"experts.{e}.{w}" for e in range(n_exp)
                for w in ("w1", "w3", "w2")))
    return (attn + [("post_attention_layernorm", ("gate_proj", "up_proj"),
                     "gate_proj"),
                    ("up_proj", ("down_proj",), "down_proj")],
            ("o_proj", "gate_proj", "up_proj", "down_proj", "v_proj"))


def run_awq(params: Dict, cfg, input_ids, n_bit: int = 4,
            group_size: int = 128, n_grid: int = 20, do_clip: bool = True,
            progress: bool = False, numeric_type: str = "int",
            device="cuda") -> Tuple[Dict, Dict]:
    """Run the AWQ search over every decoder layer of a Llama-family, OPT
    or Mixtral (per-expert layout) tree on the params' device, which must
    be of ``device``'s type.

    One forward over ``input_ids`` records every linear's input rows on the
    device; the searches run on them (the clip search on the first 512).
    Returns ``(awq_results, new_params)``: ``{"scales": {"layers.{i}.
    {producer}": {"ratio", "scales", "scales_prev", "targets"}}, "clip":
    {"layers.{i}.{linear}": ratio}}`` and the scaled, clipped tree (the
    input is not modified).
    """
    dev = generate._check_device(params, device)
    is_opt = "fc1" in params["layers"][0]
    is_moe = "experts" in params["layers"][0]
    fwd = opt.forward if is_opt else (mixtral.forward if is_moe
                                      else llama.forward)
    store = llama.Capture(raw=True)
    fwd(params, cfg, torch.as_tensor(input_ids, device=dev), capture=store)
    acts = {name: torch.cat(rows) for name, rows in store.rows.items()}
    del store

    out = _copy_tree(params)
    results: Dict = {"scales": {}, "clip": {}}
    for i, layer in enumerate(out["layers"]):
        groups, clip_targets = _schema(layer, is_opt, is_moe)
        for prev, targets, act_name in groups:
            s, ratio = search_scale(acts[f"layers.{i}.{act_name}"],
                                    [_lget(layer, t) for t in targets],
                                    n_grid=n_grid, n_bit=n_bit,
                                    group_size=group_size,
                                    numeric_type=numeric_type)
            s_prev = s
            if prev == "v_proj" and not is_opt:
                # GQA: o_proj's input repeats each kv head's channels for
                # its `rep` query heads, so an exact fold shares a scale
                # (the geometric mean) over them
                hd = cfg.head_dim_
                nkv = cfg.num_key_value_heads
                rep = cfg.num_attention_heads // nkv
                if rep > 1:
                    s_kv = torch.exp(torch.mean(torch.log(
                        s.reshape(nkv, rep, hd)), dim=1))
                    s = torch.repeat_interleave(s_kv, rep, dim=0).reshape(-1)
                    s_prev = s_kv.reshape(-1)
            _apply_scale_group(layer, prev, targets, s, s_prev)
            results["scales"][f"layers.{i}.{prev}"] = {
                "ratio": ratio, "scales": s.cpu().numpy(),
                "scales_prev": s_prev.cpu().numpy(),
                "targets": list(targets)}
            if progress:
                print(f"  awq layer {i} {prev}->{targets}: ratio {ratio:.2f}")
        if do_clip:
            # q/k are not clipped, as in the reference
            for nm in clip_targets:
                x = acts[f"layers.{i}."
                         + ("moe" if is_moe and nm.endswith(("w1", "w3"))
                            else nm)]
                clipped, cratio = search_clip(
                    x[:512], _lget(layer, nm), n_grid=max(4, n_grid // 4),
                    n_bit=n_bit, group_size=group_size, return_ratio=True,
                    numeric_type=numeric_type)
                _lset(layer, nm, clipped)
                results["clip"][f"layers.{i}.{nm}"] = cratio
    return results, out


def _lget(layer: Dict, path: str):
    node = layer
    for p in path.split("."):
        node = node[int(p) if p.isdigit() else p]
    return node


def _lset(layer: Dict, path: str, value):
    *parts, last = path.split(".")
    node = _lget(layer, ".".join(parts)) if parts else layer
    node[int(last) if last.isdigit() else last] = value


def _apply_scale_group(layer: Dict, prev: str, targets, s, s_prev):
    """Scale the targets' input channels up by ``s``; fold ``1 / s_prev``
    into the producer: a norm, or a linear's output rows (and its bias)."""
    for t in targets:
        w = _lget(layer, t)
        _lset(layer, t, (w.float() * s[None, :]).to(w.dtype))
    if prev.endswith(("layernorm", "layer_norm")):
        layer[prev] = _fold_norm(layer[prev], s_prev)
        return
    w = _lget(layer, prev)
    _lset(layer, prev, (w.float() / s_prev[:, None]).to(w.dtype))
    bkey = prev.replace("_proj", "_bias") if prev.endswith("_proj") \
        else prev + "_bias"
    if "." not in prev and bkey in layer:
        b = layer[bkey]
        layer[bkey] = (b.float() / s_prev).to(b.dtype)


def _fold_norm(norm, s):
    """``1 / s`` folded into an RMSNorm weight, or into both the weight and
    the bias of a LayerNorm ``{weight, bias}``."""
    if isinstance(norm, dict):
        return {k: (norm[k].float() / s).to(norm[k].dtype)
                for k in ("weight", "bias")}
    return (norm.float() / s).to(norm.dtype)


# the targets of each producer, for artifacts that do not list them
_DEFAULT_GROUPS = {
    "input_layernorm": ("q_proj", "k_proj", "v_proj"),
    "v_proj": ("o_proj",),
    "post_attention_layernorm": ("gate_proj", "up_proj"),
    "up_proj": ("down_proj",),
    "self_attn_layer_norm": ("q_proj", "k_proj", "v_proj"),
    "final_layer_norm": ("fc1",),
    "fc1": ("fc2",),
}


def apply_awq(params: Dict, awq_results: Dict, do_clip: bool = True,
              device="cuda") -> Dict:
    """Apply searched scales (and clip ratios) to a tree on ``device``'s
    type; returns a new tree. ``awq_results`` is :func:`run_awq`'s, or
    :func:`load_awq`'s of a file of either package."""
    dev = generate._check_device(params, device)
    out = _copy_tree(params)
    for key, info in awq_results.get("scales", {}).items():
        parts = key.split(".")
        layer = out["layers"][int(parts[1])]
        prev = ".".join(parts[2:])
        s = torch.as_tensor(np.asarray(info["scales"]), device=dev)
        s_prev = torch.as_tensor(
            np.asarray(info.get("scales_prev", info["scales"])), device=dev)
        targets = info.get("targets")
        if targets is None:
            groups = dict(_DEFAULT_GROUPS)
            if "fc1" in out["layers"][0]:
                groups["v_proj"] = ("out_proj",)
            targets = groups[prev]
        _apply_scale_group(layer, prev, targets, s, s_prev)
    if do_clip:
        for key, ratio in awq_results.get("clip", {}).items():
            parts = key.split(".")
            layer = out["layers"][int(parts[1])]
            path = ".".join(parts[2:])
            w = _lget(layer, path)
            _lset(layer, path, _clip(w.float(), float(ratio)).to(w.dtype))
    return out


def save_awq(path: str, awq_results: Dict):
    """Write an AWQ artifact (the reference's ``--dump_awq``) in the JAX
    package's ``.npz`` layout."""
    flat = {}
    for key, info in awq_results.get("scales", {}).items():
        flat[f"s::{key}::scales"] = np.asarray(info["scales"])
        flat[f"s::{key}::scales_prev"] = np.asarray(info["scales_prev"])
        flat[f"s::{key}::ratio"] = np.float32(info["ratio"])
        flat[f"s::{key}::targets"] = np.asarray(info["targets"])
    for key, ratio in awq_results.get("clip", {}).items():
        flat[f"c::{key}"] = np.float32(ratio)
    np.savez(path, **flat)


def load_awq(path: str) -> Dict:
    """Inverse of :func:`save_awq`."""
    results: Dict = {"scales": {}, "clip": {}}
    with np.load(path, allow_pickle=False) as raw:
        for name in raw.files:
            if name.startswith("s::"):
                _, key, field = name.split("::")
                entry = results["scales"].setdefault(key, {})
                if field == "ratio":
                    entry["ratio"] = float(raw[name])
                elif field == "targets":
                    entry["targets"] = [str(t) for t in raw[name]]
                else:
                    entry[field] = raw[name]
            elif name.startswith("c::"):
                results["clip"][name[3:]] = float(raw[name])
    return results


pre_quant_methods = {"awq": run_awq}
