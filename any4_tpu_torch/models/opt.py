"""Functional OPT decoder (facebook/opt-*) in PyTorch (counterpart of
``any4_tpu/models/opt.py``).

Unlike Llama: learned positional embeddings with OPT's offset of 2,
LayerNorm with bias (before each block, or after it with
``do_layer_norm_before=False`` as opt-350m has it), attention with biases
and no rotary embedding, a ReLU ``fc1``/``fc2`` MLP, and a head tied to
the token embeddings. The linear leaves (``q/k/v_proj``, ``out_proj``,
``fc1``, ``fc2``) may be dense or
:class:`~any4_tpu_torch.ops.linear.QuantizedTensor`. The forward runs the
full sequence and keeps no KV cache, as in the JAX package.

Casts follow the JAX package: LayerNorm in f32, attention logits in f32
scaled after the product, softmax in f32 with the probabilities cast back
to the model dtype.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from ..ops import linear as lin
from .llama import _capture


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    dtype: Any = torch.bfloat16

    @classmethod
    def opt_125m(cls):
        return cls()

    @classmethod
    def tiny(cls, vocab=256, layers=2):
        return cls(vocab_size=vocab, hidden_size=64, ffn_dim=128,
                   num_hidden_layers=layers, num_attention_heads=4,
                   max_position_embeddings=128)


def init_params(cfg: OPTConfig, seed: int = 0, device="cuda") -> Dict:
    """Random-initialized parameters, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: linear weights ``N(0, 1/k)``,
    embeddings ``0.02 * N(0, 1)``, biases 0 and LayerNorms at identity.
    (The numbers differ from the JAX package's ``jax.random``.)"""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f = cfg.hidden_size, cfg.ffn_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    def dense(n_out, n_in):
        return (normal(n_out, n_in) * (1.0 / n_in ** 0.5)).to(cfg.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=cfg.dtype, device=device)

    def norm():
        return {"weight": torch.ones((d,), dtype=cfg.dtype, device=device),
                "bias": zeros(d)}

    params: Dict[str, Any] = {
        "embed_tokens": normal(cfg.vocab_size, d).to(cfg.dtype) * 0.02,
        "embed_positions": normal(cfg.max_position_embeddings + 2, d).to(
            cfg.dtype) * 0.02,
        "final_layer_norm": norm(),
        "layers": [],
    }
    for _ in range(cfg.num_hidden_layers):
        params["layers"].append({
            "self_attn_layer_norm": norm(), "final_layer_norm": norm(),
            "q_proj": dense(d, d), "k_proj": dense(d, d),
            "v_proj": dense(d, d), "out_proj": dense(d, d),
            "q_bias": zeros(d), "k_bias": zeros(d), "v_bias": zeros(d),
            "out_bias": zeros(d),
            "fc1": dense(f, d), "fc1_bias": zeros(f),
            "fc2": dense(d, f), "fc2_bias": zeros(d),
        })
    return params


def layer_norm(x: torch.Tensor, p: Dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["weight"].float() + p["bias"].float()).to(dt)


def forward(params: Dict, cfg: OPTConfig, input_ids: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None,
            capture: Optional[dict] = None, **kw):
    """Full-sequence forward. Returns ``(logits [b, t, vocab], None)``;
    ``kw`` goes to :func:`~any4_tpu_torch.ops.linear.linear`. ``capture``
    records the inputs of q/k/v, ``out_proj``, ``fc1`` and ``fc2`` as
    :func:`.llama.forward` does."""
    b, t = input_ids.shape
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    x = lin.embed(params["embed_tokens"], input_ids)
    # OPT's learned positions carry an offset of 2 (HF's
    # OPTLearnedPositionalEmbedding)
    x = x + params["embed_positions"][positions.long() + 2].to(x.dtype)
    x = x.to(cfg.dtype)

    if mask is None and t > 1:
        mask = torch.where(torch.ones((t, t), dtype=torch.bool,
                                      device=dev).tril(),
                           0.0, -1e9)[None, None].float()

    nh = cfg.num_attention_heads
    hd = cfg.hidden_size // nh
    # 1 / sqrt(hd) rounded in f32, as the JAX package computes it
    scale = float(1.0 / torch.sqrt(torch.tensor(float(hd))))

    for li, layer in enumerate(params["layers"]):
        pre = f"layers.{li}."
        res = x
        h = layer_norm(x, layer["self_attn_layer_norm"]) \
            if cfg.do_layer_norm_before else x
        if capture is not None:
            for nm in ("q_proj", "k_proj", "v_proj"):
                _capture(capture, pre + nm, h)
        q = lin.linear(h, layer["q_proj"], layer["q_bias"], **kw)
        k = lin.linear(h, layer["k_proj"], layer["k_bias"], **kw)
        v = lin.linear(h, layer["v_proj"], layer["v_bias"], **kw)
        q = q.reshape(b, t, nh, hd)
        k = k.reshape(b, t, nh, hd)
        v = v.reshape(b, t, nh, hd)
        logits = torch.einsum("bthd,bshd->bhts", q.float(),
                              k.float()) * scale
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.einsum("bhts,bshd->bthd", probs, v.to(x.dtype)).reshape(
            b, t, nh * hd)
        if capture is not None:
            _capture(capture, pre + "out_proj", o)
        o = lin.linear(o, layer["out_proj"], layer["out_bias"], **kw)
        x = res + o
        if not cfg.do_layer_norm_before:
            x = layer_norm(x, layer["self_attn_layer_norm"])

        res = x
        h = layer_norm(x, layer["final_layer_norm"]) \
            if cfg.do_layer_norm_before else x
        if capture is not None:
            _capture(capture, pre + "fc1", h)
        h = lin.linear(h, layer["fc1"], layer["fc1_bias"], **kw)
        h = torch.clamp_min(h, 0)
        if capture is not None:
            _capture(capture, pre + "fc2", h)
        h = lin.linear(h, layer["fc2"], layer["fc2_bias"], **kw)
        x = res + h
        if not cfg.do_layer_norm_before:
            x = layer_norm(x, layer["final_layer_norm"])

    x = layer_norm(x, params["final_layer_norm"])
    emb = params["embed_tokens"]
    if isinstance(emb, lin.QuantizedTensor):
        logits = lin.linear(x, emb, **kw)
    else:
        logits = x @ emb.t().to(x.dtype)
    return logits, None


def config_from_hf(hf: Dict) -> OPTConfig:
    """An :class:`OPTConfig` from an HF ``config.json`` dict."""
    return OPTConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        ffn_dim=hf["ffn_dim"], num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        max_position_embeddings=hf["max_position_embeddings"],
        do_layer_norm_before=hf.get("do_layer_norm_before", True))


def params_from_hf(cfg: OPTConfig, arr) -> Dict:
    """The parameter tree from ``arr(name)``, which returns the HF tensor
    ``name`` (without the ``model.decoder.`` prefix) as the tree holds it."""
    params = {
        "embed_tokens": arr("embed_tokens.weight"),
        "embed_positions": arr("embed_positions.weight"),
        "final_layer_norm": {"weight": arr("final_layer_norm.weight"),
                             "bias": arr("final_layer_norm.bias")},
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        layer = {nrm: {"weight": arr(p + nrm + ".weight"),
                       "bias": arr(p + nrm + ".bias")}
                 for nrm in ("self_attn_layer_norm", "final_layer_norm")}
        for nm in ("q", "k", "v", "out"):
            layer[f"{nm}_proj"] = arr(p + f"self_attn.{nm}_proj.weight")
            layer[f"{nm}_bias"] = arr(p + f"self_attn.{nm}_proj.bias")
        for nm in ("fc1", "fc2"):
            layer[nm] = arr(p + nm + ".weight")
            layer[nm + "_bias"] = arr(p + nm + ".bias")
        params["layers"].append(layer)
    return params


def load_hf_opt(model_dir: str, dtype=torch.bfloat16, device="cuda"):
    """Load an HF OPT checkpoint directory (safetensors shards) into
    ``(cfg, params)``, the weights on ``device`` in ``dtype``."""
    from .loader import _open_shards

    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    get, names = _open_shards(model_dir)

    def arr(name):
        pfx = "model.decoder." if f"model.decoder.{name}" in names else ""
        return get(pfx + name).to(device=device, dtype=dtype)

    return cfg, params_from_hf(cfg, arr)
