"""Per-component decode profiler (counterpart of ``any4_tpu/profiler.py``).

It times each decoder layer's attention and MLP alone on decode-shaped
inputs with the best-window clock of :func:`.utils.best_in_ms` (on the
card: CUDA events, the L2 emptied before each call). The split answers
where a decode step spends its device time, attention or MLP, and in which
layers.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .models import llama
from .utils import Timer, best_in_ms


def profile_decode_components(params: Dict, cfg, batch: int = 1,
                              ctx: int = 256,
                              max_layers: Optional[int] = None,
                              iters: int = 20, rounds: int = 6) -> Dict:
    """Time attention vs MLP per layer at decode shapes (m = ``batch``, one
    token at position ``ctx // 2`` of a ``ctx``-long cache), on the device
    of ``params``; the input is drawn from a ``torch.Generator`` seeded
    with 0.

    Returns ``{"layers.N": {"attention_ms", "mlp_ms"}, ..., "totals":
    {...}}``; with ``max_layers`` only the first layers are timed and the
    totals are scaled to the whole depth. Each component is called ``1 +
    rounds * iters`` times a layer. The numbers are not rounded (the JAX
    package rounds them to 4 decimals).
    """
    emb = params["embed_tokens"]
    dev = getattr(emb, "packed", emb).device
    hd, nkv, d = cfg.head_dim_, cfg.num_key_value_heads, cfg.hidden_size
    pos = ctx // 2
    positions = torch.full((batch, 1), pos, dtype=torch.long, device=dev)
    cos, sin = llama.rope_tables(cfg, positions)
    mask = llama.decode_mask(ctx, pos, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((batch, 1, d), generator=gen, device=dev,
                    dtype=torch.float32).to(cfg.dtype)
    kc = torch.zeros((batch, ctx, nkv, hd), dtype=cfg.dtype, device=dev)
    vc = torch.zeros_like(kc)
    timer = Timer(device=dev) if dev.type == "cuda" else None

    results: Dict = {}
    t_att_total = t_mlp_total = 0.0
    layers = params["layers"]
    n = len(layers) if max_layers is None else min(max_layers, len(layers))
    for i in range(n):
        layer = layers[i]
        ms = best_in_ms({
            "attention_ms": lambda: llama.attention(
                layer, cfg, x, cos, sin, (kc, vc), pos, mask)[0],
            "mlp_ms": lambda: llama.mlp(layer, x, cfg.hidden_act)},
            iters=iters, rounds=rounds, timer=timer)
        results[f"layers.{i}"] = ms
        t_att_total += ms["attention_ms"]
        t_mlp_total += ms["mlp_ms"]
    scale = len(layers) / max(n, 1)  # extrapolate if truncated
    results["totals"] = {
        "attention_ms": t_att_total * scale,
        "mlp_ms": t_mlp_total * scale,
        "attention_share": t_att_total / max(t_att_total + t_mlp_total,
                                             1e-12),
        "sum_ms": (t_att_total + t_mlp_total) * scale,
        "layers_profiled": n,
    }
    return results
