"""Llama-architecture layers (:mod:`portbench.archs.llama`) as the port
runs them: ``models/llama.py``'s ``LlamaConfig`` and forward, q/k/v and
gate/up fused by ``models.fuse.fuse_projections``."""
from __future__ import annotations

import torch

from portbench.inputs import hf


def config_keys(config: dict) -> dict:
    """The ``LlamaConfig`` fields of a configuration file."""
    return dict(
        vocab_size=hf(config, "vocab_size"),
        hidden_size=hf(config, "hidden_size"),
        intermediate_size=hf(config, "intermediate_size"),
        num_hidden_layers=hf(config, "num_hidden_layers"),
        num_attention_heads=hf(config, "num_attention_heads"),
        num_key_value_heads=hf(config, "num_key_value_heads"),
        head_dim=hf(config, "head_dim"),
        max_position_embeddings=hf(config, "max_position_embeddings"),
        rms_norm_eps=hf(config, "rms_norm_eps"),
        rope_theta=hf(config, "rope_theta"),
        tie_word_embeddings=hf(config, "tie_word_embeddings", False),
        hidden_act=hf(config, "hidden_act", "silu"),
        sliding_window=hf(config, "sliding_window"),
        dtype=torch.bfloat16)


def model_config(config: dict):
    from any4_tpu_torch.models import llama
    return llama.LlamaConfig(**config_keys(config))


def norms(ones: torch.Tensor) -> dict:
    return {"input_layernorm": ones.clone(),
            "post_attention_layernorm": ones.clone()}


def fused(layer: dict) -> dict:
    from any4_tpu_torch.models import fuse
    return fuse.fuse_projections({"layers": [layer]})["layers"][0]


def layer(config: dict, layer: int, packed: dict, dense: dict, ones):
    return fused(dict(norms(ones), **packed))


def ffn(layer: dict, cfg, h):
    from any4_tpu_torch.models import llama
    return llama.mlp(layer, h, cfg.hidden_act)
