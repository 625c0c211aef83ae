"""Mixtral's decoder blocks: Llama's attention (:mod:`.llama`), and in
every layer ``num_local_experts`` SwiGLU experts (``experts.<e>.w1``,
``.w3``, ``.w2``) behind a dense bf16 router ``[E, d]``, drawn ``N(0,
1/d)`` after the layer's linears. A token's top ``num_experts_per_tok``
router logits (the lower index first among equal ones) are softmaxed and
weight their experts' outputs. Plain PyTorch; nothing of the port."""
from __future__ import annotations

import math

import torch

from portbench.archs import llama
from portbench.archs.llama import attention_flops, check  # noqa: F401
from portbench.inputs import hf


def linears(config: dict, layer: int):
    d = hf(config, "hidden_size")
    f = hf(config, "intermediate_size")
    out = llama.attention_linears(config)
    for e in range(hf(config, "num_local_experts")):
        out += [(f"experts.{e}.w1", f, d), (f"experts.{e}.w3", f, d),
                (f"experts.{e}.w2", d, f)]
    return out


def experts(config: dict, layer: int):
    return ("experts.", hf(config, "num_local_experts"),
            hf(config, "num_experts_per_tok"))


def draw_dense(config: dict, layer: int, gen, device) -> dict:
    d = hf(config, "hidden_size")
    return {"router": (torch.randn((hf(config, "num_local_experts"), d),
                                   generator=gen, device=device)
                       / math.sqrt(d)).to(torch.bfloat16)}


def extra_flops(config: dict, layer: int) -> float:
    """The router's."""
    return 2.0 * hf(config, "hidden_size") * hf(config, "num_local_experts")


def tiny(config: dict, f32: bool = False) -> dict:
    # top 2 of 2: at two layers of width 128 a router near-tie that bf16
    # tips moves a position's logits as far as fp8 does, so the tiny runs
    # route every token to both experts; a layer compared in float32 routes
    # 2 of 4
    return dict(llama.TINY, num_local_experts=4 if f32 else 2)


# ---------------------------------------------------------------- reference
def ffn(ref, h, w, layer: int):
    """The routed FFN's output, and how far each position's last chosen
    expert lies above the first one left out (inf when every expert is
    chosen)."""
    E = hf(ref.config, "num_local_experts")
    K = hf(ref.config, "num_experts_per_tok")
    logits = h @ w["router"].t()
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    margin = (order.values[:, K - 1] - order.values[:, K] if K < E
              else torch.full_like(logits[:, 0], math.inf))
    top = order.indices[:, :K]
    gate = torch.softmax(order.values[:, :K], dim=-1)
    out = torch.zeros_like(h)
    for e in range(E):
        rows, slot = (top == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = llama.swiglu(ref, h[rows], w[f"experts.{e}.w1"],
                         w[f"experts.{e}.w3"], w[f"experts.{e}.w2"])
        out.index_add_(0, rows, y * gate[rows, slot][:, None])
    return ref.s(out), margin


def layer(ref, x, w, layer: int):
    return llama.block(ref, x, w, layer, ffn)
