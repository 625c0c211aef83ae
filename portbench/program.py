"""The system under test, built from the drawn inputs: the port's kernels,
its config object, its quantized leaves packed by the port
(``pack/<format>.py``), and the port's own projection fusion. The port is
imported here, in :mod:`.drive`, ``pack/`` and ``drivers/``, and nowhere
else in the harness.
"""
from __future__ import annotations

import time

import torch

from . import inputs

# the model types the harness builds, by the class of the port that runs it
_LLAMA_TYPES = ("llama", "mistral")
_MOE_TYPES = ("mixtral",)


def model_config(config: dict):
    """The port's ``LlamaConfig`` or ``MixtralConfig`` of a configuration
    file (bf16 activations)."""
    from any4_tpu_torch.models import llama, mixtral
    hf = inputs.hf
    mt = hf(config, "model_type")
    if mt not in _LLAMA_TYPES + _MOE_TYPES:
        raise ValueError(f"model_type {mt!r} is not one the harness builds")
    common = dict(
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
    if mt in _MOE_TYPES:
        return mixtral.MixtralConfig(
            **common, num_local_experts=hf(config, "num_local_experts"),
            num_experts_per_tok=hf(config, "num_experts_per_tok"))
    return llama.LlamaConfig(**common)


def build_kernels(device) -> float:
    """Seconds to build the port's CUDA libraries into its ``_build/``, all
    at once, or to find them built there (0 off the card)."""
    if torch.device(device).type != "cuda":
        return 0.0
    from any4_tpu_torch.ops import build
    t = time.perf_counter()
    build.build_all()
    return time.perf_counter() - t


def pack(config: dict, f):
    """The port's quantized leaf of one linear's drawn fields, by the
    configuration's format (``pack/<format>.py``)."""
    from . import pack as packing
    q = config["quantization"]
    return packing.load(q["format"]).pack(f, q["group_size"])


def build_params(config: dict, seed: int, device) -> dict:
    """The port's parameter tree of a configuration file, layer by layer:
    each layer's drawn fields are packed, then fused by
    ``models.fuse.fuse_projections`` before the next layer is drawn."""
    from any4_tpu_torch.models import fuse
    d = inputs.hf(config, "hidden_size")
    ones = torch.ones(d, dtype=torch.bfloat16, device=device)
    params = dict(inputs.draw_dense(config, seed, device))
    params["norm"] = ones.clone()
    params["layers"] = []
    for li in range(inputs.hf(config, "num_hidden_layers")):
        fields, router = inputs.draw_layer(config, seed, li, device)
        layer = {"input_layernorm": ones.clone(),
                 "post_attention_layernorm": ones.clone()}
        experts = {}
        for name, f in fields.items():
            qt = pack(config, f)
            if name.startswith("experts."):
                _, e, w = name.split(".")
                experts.setdefault(int(e), {})[w] = qt
            else:
                layer[name] = qt
        if router is not None:
            layer["router"] = router
            layer["experts"] = [experts[e] for e in sorted(experts)]
        del fields
        params["layers"].append(
            fuse.fuse_projections({"layers": [layer]})["layers"][0])
    return params
