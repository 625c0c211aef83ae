"""Llama-architecture decoder blocks: RMSNorm, grouped-query causal
attention with half-split RoPE (base ``rope_theta``) and a softmax in
float32, and a SwiGLU MLP (``gate_proj``, ``up_proj``, ``down_proj``),
the same in every layer. No sliding window. Plain PyTorch; nothing of
the port."""
from __future__ import annotations

import math

import torch

from portbench.inputs import hf

TINY = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=512)


def head_dim(config: dict) -> int:
    return hf(config, "head_dim") or (hf(config, "hidden_size")
                                      // hf(config, "num_attention_heads"))


def attention_linears(config: dict):
    """q, k, v and o of grouped-query attention."""
    d = hf(config, "hidden_size")
    hd = head_dim(config)
    nq = hf(config, "num_attention_heads")
    nkv = hf(config, "num_key_value_heads", nq)
    return [("q_proj", nq * hd, d), ("k_proj", nkv * hd, d),
            ("v_proj", nkv * hd, d), ("o_proj", d, nq * hd)]


def linears(config: dict, layer: int):
    d = hf(config, "hidden_size")
    f = hf(config, "intermediate_size")
    return attention_linears(config) + [
        ("gate_proj", f, d), ("up_proj", f, d), ("down_proj", d, f)]


def experts(config: dict, layer: int):
    return None


def draw_dense(config: dict, layer: int, gen, device) -> dict:
    return {}


def extra_flops(config: dict, layer: int) -> float:
    return 0.0


def attention_flops(config: dict, layer: int, ctx: float) -> float:
    return 4.0 * hf(config, "num_attention_heads") * head_dim(config) * ctx


def tiny(config: dict, f32: bool = False) -> dict:
    return dict(TINY)


# ---------------------------------------------------------------- reference
def check(config: dict) -> None:
    if hf(config, "hidden_act", "silu") != "silu":
        raise ValueError("the reference runs SiLU MLPs only")
    if hf(config, "sliding_window") is not None:
        raise ValueError("the reference runs full attention only")


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [t, heads, hd]`` rotated at positions ``pos [t]``."""
    hd = x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(0, hd, 2, device=x.device,
                                  dtype=torch.float64) / hd)
    ang = pos.double()[:, None] * inv[None, :]
    c, s = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(ref, h, w):
    config = ref.config
    hd = head_dim(config)
    nq = hf(config, "num_attention_heads")
    nkv = hf(config, "num_key_value_heads", nq)
    theta = hf(config, "rope_theta")
    t = h.shape[0]
    pos = torch.arange(t, device=h.device)
    q = ref.s(rope(ref.lin(h, w["q_proj"]).view(t, nq, hd), pos, theta))
    k = ref.s(rope(ref.lin(h, w["k_proj"]).view(t, nkv, hd), pos, theta))
    v = ref.lin(h, w["v_proj"]).view(t, nkv, hd)
    rep = nq // nkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    probs = ref.s(torch.softmax(logits, -1))
    out = ref.s(torch.einsum("hts,shd->thd", probs, v))
    return ref.lin(out.reshape(t, nq * hd), w["o_proj"])


def swiglu(ref, h, w1, w3, w2):
    act = ref.s(torch.nn.functional.silu(ref.lin(h, w1)))
    return ref.lin(ref.s(act * ref.lin(h, w3)), w2)


def ffn(ref, h, w, layer: int):
    """The MLP's output and no router margin."""
    return swiglu(ref, h, w["gate_proj"], w["up_proj"], w["down_proj"]), None


def block(ref, x, w, layer: int, ffn):
    """A pre-norm decoder layer: attention, then ``ffn(ref, h, w,
    layer)``."""
    x = ref.s(x + attention(ref, ref.norm(x), w))
    y, margin = ffn(ref, ref.norm(x), w, layer)
    return ref.s(x + y), margin


def layer(ref, x, w, layer: int):
    return block(ref, x, w, layer, ffn)
