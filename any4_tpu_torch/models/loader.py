"""HF checkpoints and ``transformers`` models into the port's parameter trees
(counterpart of ``any4_tpu/models/loader.py``).

The ``load_*`` functions read a checkpoint directory (``config.json`` and
safetensors shards, with or without ``model.safetensors.index.json``); the
``convert_torch_*`` functions take an instantiated ``transformers`` model.
Either way the weights land as tensors on ``device`` in ``dtype``, or, with
``as_numpy=True``, as float32 numpy arrays on the host. ``safetensors`` and
``transformers`` are imported only by the functions that need them.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Tuple

import torch

from . import llama, mixtral, opt


def _cfg_from_hf(config: dict) -> llama.LlamaConfig:
    mt = config.get("model_type", "llama")
    gemma: dict = {}
    if mt in ("gemma", "gemma2"):
        # gemma family: (1+w) norms, tanh-gelu MLP, sqrt(d)-scaled embeds
        layer_types = config.get("layer_types")
        gemma = dict(
            # HF runs gemma's MLP with tanh-gelu even where an old config
            # says hidden_act='gelu' (the checkpoints were trained with the
            # tanh approximation); only the corrected 'hidden_activation'
            # key is honored, as in transformers
            hidden_act=config.get("hidden_activation",
                                  "gelu_pytorch_tanh"),
            rms_norm_offset=1.0,
            embed_scale=float(config["hidden_size"]) ** 0.5,
        )
        if mt == "gemma2":
            gemma.update(
                query_pre_attn_scalar=config.get("query_pre_attn_scalar"),
                attn_logit_softcapping=config.get("attn_logit_softcapping"),
                final_logit_softcapping=config.get(
                    "final_logit_softcapping"),
                sliding_window=config.get("sliding_window"),
                layer_types=(tuple(layer_types) if layer_types else None),
                sandwich_norms=True,
            )
    return llama.LlamaConfig(
        vocab_size=config["vocab_size"],
        hidden_size=config["hidden_size"],
        intermediate_size=config["intermediate_size"],
        num_hidden_layers=config["num_hidden_layers"],
        num_attention_heads=config["num_attention_heads"],
        num_key_value_heads=config.get("num_key_value_heads",
                                       config["num_attention_heads"]),
        head_dim=config.get("head_dim"),
        max_position_embeddings=config.get("max_position_embeddings", 4096),
        rms_norm_eps=config.get("rms_norm_eps", 1e-5),
        rope_theta=config.get("rope_theta", 10000.0),
        tie_word_embeddings=config.get("tie_word_embeddings", mt == "gemma"
                                       or mt == "gemma2"),
        attention_bias=config.get("attention_bias", False),
        **gemma,
    )


def _mixtral_cfg_from_hf(config: dict) -> mixtral.MixtralConfig:
    base = _cfg_from_hf(config)
    return mixtral.MixtralConfig(
        **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
        num_local_experts=config.get("num_local_experts", 8),
        num_experts_per_tok=config.get("num_experts_per_tok", 2))


def _open_shards(model_dir: str):
    """``(get, names)``: ``get(name)`` reads one tensor of the directory's
    safetensors shards as a CPU torch tensor; ``names`` is every name."""
    from safetensors import safe_open
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
        files = sorted(set(weight_map.values()))
    else:
        files = sorted(f for f in os.listdir(model_dir)
                       if f.endswith(".safetensors"))
        weight_map = None
    handles = {fn: safe_open(os.path.join(model_dir, fn), framework="pt")
               for fn in files}
    if weight_map is None:
        weight_map = {k: fn for fn, h in handles.items() for k in h.keys()}

    def get(name: str) -> torch.Tensor:
        return handles[weight_map[name]].get_tensor(name)

    return get, set(weight_map)


def _make_arr(get, as_numpy: bool, dtype, device) -> Callable:
    """Reader of checkpoint tensors: on ``device`` in ``dtype``, or (with
    ``as_numpy``) float32 numpy on the host."""
    if as_numpy:
        return lambda name: get(name).float().numpy()
    return lambda name: get(name).to(device=device, dtype=dtype)


def _decoder_params(cfg, arr, has, moe: bool) -> Dict:
    """A Llama-family (``moe``: Mixtral) tree from HF tensor names, with
    Qwen2-style attention biases and gemma2's sandwich norms where the
    checkpoint has them."""
    params: Dict = {"embed_tokens": arr("model.embed_tokens.weight"),
                    "norm": arr("model.norm.weight"), "layers": []}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        layer = {
            "input_layernorm": arr(p + "input_layernorm.weight"),
            "post_attention_layernorm":
                arr(p + "post_attention_layernorm.weight"),
            **{f"{nm}_proj": arr(p + f"self_attn.{nm}_proj.weight")
               for nm in "qkvo"},
        }
        if moe:
            moe_p = p + "block_sparse_moe."
            layer["router"] = arr(moe_p + "gate.weight")
            layer["experts"] = [
                {w: arr(moe_p + f"experts.{e}.{w}.weight")
                 for w in ("w1", "w3", "w2")}
                for e in range(cfg.num_local_experts)]
        else:
            for nm in ("gate", "up", "down"):
                layer[f"{nm}_proj"] = arr(p + f"mlp.{nm}_proj.weight")
        for nm in "qkvo":
            if has(p + f"self_attn.{nm}_proj.bias"):
                layer[f"{nm}_bias"] = arr(p + f"self_attn.{nm}_proj.bias")
        for nrm in ("pre_feedforward_layernorm",
                    "post_feedforward_layernorm"):
            if has(p + nrm + ".weight"):
                layer[nrm] = arr(p + nrm + ".weight")
        params["layers"].append(layer)
    if not cfg.tie_word_embeddings and has("lm_head.weight"):
        params["lm_head"] = arr("lm_head.weight")
    return params


def _read_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def load_model(model_dir: str, dtype=torch.bfloat16, as_numpy: bool = False,
               device="cuda"):
    """Load an HF checkpoint directory by config.json's ``model_type``:
    Mixtral, otherwise the Llama family."""
    if _read_config(model_dir).get("model_type", "llama") == "mixtral":
        return load_mixtral(model_dir, dtype, as_numpy, device)
    return load_llama(model_dir, dtype, as_numpy, device)


def load_llama(model_dir: str, dtype=torch.bfloat16, as_numpy: bool = False,
               device="cuda") -> Tuple[llama.LlamaConfig, Dict]:
    """Load an HF Llama/Mistral/Qwen2/Gemma-style checkpoint directory."""
    cfg = _cfg_from_hf(_read_config(model_dir))
    get, names = _open_shards(model_dir)
    return cfg, _decoder_params(cfg, _make_arr(get, as_numpy, dtype, device),
                                names.__contains__, moe=False)


def load_mixtral(model_dir: str, dtype=torch.bfloat16, as_numpy: bool = False,
                 device="cuda") -> Tuple[mixtral.MixtralConfig, Dict]:
    """Load an HF Mixtral checkpoint directory: Llama attention and norms,
    ``block_sparse_moe.gate`` (the router) and ``experts.{e}.w1/w3/w2``."""
    cfg = _mixtral_cfg_from_hf(_read_config(model_dir))
    get, names = _open_shards(model_dir)
    return cfg, _decoder_params(cfg, _make_arr(get, as_numpy, dtype, device),
                                names.__contains__, moe=True)


def _state_arr(model, dtype, device):
    """``(arr, has)`` over a ``transformers`` model's state dict, each
    tensor through float32 to ``dtype`` on ``device``."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    return (lambda name: sd[name].float().to(device=device, dtype=dtype),
            sd.__contains__)


def convert_torch_llama(model, dtype=torch.bfloat16, device="cuda"):
    """An instantiated ``transformers`` Llama-family model as ``(cfg,
    params)`` for :mod:`.llama`."""
    cfg = _cfg_from_hf(model.config.to_dict())
    return cfg, _decoder_params(cfg, *_state_arr(model, dtype, device),
                                moe=False)


def convert_torch_mixtral(model, dtype=torch.bfloat16, device="cuda"):
    """An instantiated ``transformers`` ``MixtralForCausalLM`` as ``(cfg,
    params)`` for :mod:`.mixtral`."""
    cfg = _mixtral_cfg_from_hf(model.config.to_dict())
    return cfg, _decoder_params(cfg, *_state_arr(model, dtype, device),
                                moe=True)


def convert_torch_opt(model, dtype=torch.bfloat16, device="cuda"):
    """An instantiated ``transformers`` ``OPTForCausalLM`` as ``(cfg,
    params)`` for :mod:`.opt`."""
    cfg = opt.config_from_hf(model.config.to_dict())
    arr, has = _state_arr(model, dtype, device)
    pfx = "model.decoder."
    return cfg, opt.params_from_hf(
        cfg, lambda name: arr(pfx + name if has(pfx + name) else name))


def load_hf_torch_model(name_or_dir: str, dtype=torch.bfloat16,
                        device="cuda"):
    """Build a model with ``transformers`` (float32, on the CPU) and convert
    it: Mixtral by its config's ``model_type``, otherwise the Llama
    family."""
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(name_or_dir,
                                                 torch_dtype=torch.float32)
    if getattr(model.config, "model_type", "") == "mixtral":
        return convert_torch_mixtral(model, dtype, device)
    return convert_torch_llama(model, dtype, device)
