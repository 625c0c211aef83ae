"""Mixtral's layers (:mod:`portbench.archs.mixtral`) as the port runs
them: ``models/mixtral.py``'s ``MixtralConfig`` and forward, the router
dense bf16, each expert's w1/w3 fused by ``models.fuse.fuse_projections``."""
from __future__ import annotations

from portbench.build import llama
from portbench.inputs import hf


def model_config(config: dict):
    from any4_tpu_torch.models import mixtral
    return mixtral.MixtralConfig(
        **llama.config_keys(config),
        num_local_experts=hf(config, "num_local_experts"),
        num_experts_per_tok=hf(config, "num_experts_per_tok"))


def layer(config: dict, layer: int, packed: dict, dense: dict, ones):
    out, experts = llama.norms(ones), {}
    for name, leaf in packed.items():
        if name.startswith("experts."):
            _, e, w = name.split(".")
            experts.setdefault(int(e), {})[w] = leaf
        else:
            out[name] = leaf
    out["router"] = dense["router"]
    out["experts"] = [experts[e] for e in sorted(experts)]
    return llama.fused(out)


def ffn(layer: dict, cfg, h):
    from any4_tpu_torch.models import mixtral
    return mixtral.moe_ffn(layer, cfg, h)
