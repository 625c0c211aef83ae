"""The port's OPT (``any4_tpu_torch.models.opt``) against the JAX package,
on the CPU.

Parameters are made by the JAX package from a seed (biases and LayerNorms
drawn at random, so that they count) and carried across with
``convert.from_jax_params(..., device="cpu")``; token ids are made by numpy
from a seed. Bars: dense float32 logits within 1e-4 * max|ref| with the
LayerNorm before each block and after it (opt-350m's layout), with default
and explicit positions; any4 (g=128, every linear ``any4t``) and int4
models within 2e-2 * max of JAX's interpreted kernels, the any4 one also
with its tied table quantized (the head through the quantized kernel).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.models import opt as jopt
from any4_tpu.quant import api as japi
from any4_tpu_torch import convert
from any4_tpu_torch.models import opt
from any4_tpu_torch.ops import linear as lin
from test_torch_convert import assert_close_max, jax_to_numpy


def _configs(dtype="float32", **over):
    jcfg = dataclasses.replace(jopt.OPTConfig.tiny(), **over,
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(opt.OPTConfig.tiny(), **over,
                               dtype=getattr(torch, dtype))
    return jcfg, tcfg


def _randomize(params, seed):
    """Biases and LayerNorm weights drawn at random (init_params sets them
    to 0 and 1)."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(lambda a: a, params)

    def draw(a, scale, center=0.0):
        return jnp.asarray(center + scale * rng.standard_normal(a.shape),
                           a.dtype)

    for layer in [out] + out["layers"]:
        for key, val in list(layer.items()):
            if key.endswith("_bias"):
                layer[key] = draw(val, 0.1)
            elif key.endswith("layer_norm"):
                layer[key] = {"weight": draw(val["weight"], 0.1, 1.0),
                              "bias": draw(val["bias"], 0.1)}
    return out


def _port(tree):
    return convert.from_jax_params(jax_to_numpy(tree), device="cpu")


def _ids(b=2, t=10, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _jax_logits(params, cfg, ids, positions=None):
    pos = None if positions is None else jnp.asarray(positions)
    return np.asarray(jopt.forward(params, cfg, jnp.asarray(ids),
                                   positions=pos)[0], np.float32)


def _port_logits(params, cfg, ids, positions=None):
    pos = None if positions is None else torch.from_numpy(positions)
    return opt.forward(params, cfg, torch.from_numpy(ids),
                       positions=pos)[0].float()


@pytest.mark.parametrize("before", [True, False])
@pytest.mark.parametrize("explicit_positions", [False, True])
def test_dense_forward_matches_jax(before, explicit_positions):
    jcfg, tcfg = _configs(do_layer_norm_before=before)
    jp = _randomize(jopt.init_params(jcfg, jax.random.PRNGKey(0)), 1)
    ids = _ids(t=12)
    positions = (np.array([[3 + i for i in range(12)], list(range(12))],
                          np.int32) if explicit_positions else None)
    got = _port_logits(_port(jp), tcfg, ids, positions)
    assert got.shape == (2, 12, 256)
    assert_close_max(got, _jax_logits(jp, jcfg, ids, positions), 1e-4)


def test_bf16_forward_matches_jax():
    jcfg, tcfg = _configs(dtype="bfloat16")
    jp = _randomize(jopt.init_params(jcfg, jax.random.PRNGKey(2)), 3)
    ids = _ids(t=9, seed=4)
    got, _ = opt.forward(_port(jp), tcfg, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    assert_close_max(got.float(), _jax_logits(jp, jcfg, ids), 2e-2)


def test_causal():
    _, tcfg = _configs()
    params = opt.init_params(tcfg, seed=0, device="cpu")
    ids = _ids(b=1, t=8, seed=5)
    ids2 = ids.copy()
    ids2[0, -1] = (ids2[0, -1] + 1) % tcfg.vocab_size
    a = _port_logits(params, tcfg, ids)
    b = _port_logits(params, tcfg, ids2)
    assert torch.equal(a[:, :-1], b[:, :-1])
    assert not torch.equal(a[:, -1], b[:, -1])


@pytest.mark.parametrize("fmt,kind,qemb", [("any4", "any4t", False),
                                           ("any4", "any4t", True),
                                           ("int4", "int4p", False)])
def test_quantized_logits_match_jax(fmt, kind, qemb):
    jcfg, tcfg = _configs(hidden_size=128, ffn_dim=256)
    jp = _randomize(jopt.init_params(jcfg, jax.random.PRNGKey(6)), 7)
    jq = japi.quantize_model(jp, fmt=fmt, group_size=128, kmeans_iters=5,
                             quantize_embeddings=qemb or None)
    tq = _port(jq)
    for layer in tq["layers"]:
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"):
            assert isinstance(layer[nm], lin.QuantizedTensor)
            assert layer[nm].fmt == kind, nm
    assert isinstance(tq["embed_tokens"], lin.QuantizedTensor) == qemb
    assert isinstance(tq["embed_positions"], torch.Tensor)
    ids = _ids(t=10, seed=8)
    assert_close_max(_port_logits(tq, tcfg, ids), _jax_logits(jq, jcfg, ids),
                     2e-2)


def test_init_params():
    cfg = opt.OPTConfig.tiny()
    p = opt.init_params(cfg, seed=0, device="cpu")
    assert p["embed_positions"].shape == (cfg.max_position_embeddings + 2,
                                          64)
    layer = p["layers"][0]
    assert layer["fc1"].shape == (128, 64) and layer["fc2"].shape == (64, 128)
    assert layer["q_proj"].dtype == torch.bfloat16
    assert torch.equal(layer["self_attn_layer_norm"]["weight"],
                       torch.ones(64, dtype=torch.bfloat16))
    again = opt.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"][1]["fc2"], p["layers"][1]["fc2"])
    assert not torch.equal(layer["q_proj"], layer["k_proj"])
    assert opt.OPTConfig.opt_125m() == opt.OPTConfig()
    assert (opt.OPTConfig.opt_125m().hidden_size,
            opt.OPTConfig.opt_125m().num_hidden_layers) == (768, 12)
