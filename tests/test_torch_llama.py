"""The slice as a whole on the CPU: the port's Llama forward, quantization,
generation and checkpoints against the JAX package, on ``LlamaConfig.tiny``
and a tiny Gemma2-style config (softcaps, sliding window, sandwich norms).

Parameters are made by the JAX package from a seed and carried across as
numpy. Bars:
- dense float32 logits within 1e-4 * max|ref| (the same ops; only float32
  sums run in another order);
- any4 logits within 2e-2 * max|ref| (the repo's kernel bar) and greedy
  tokens identical over 8 new tokens;
- both packages quantizing the same weights with the deterministic nf4
  init: LUTs within 1e-4;
- checkpoints written by either package load in the other and give the
  same logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.models import checkpoint as jckpt
from any4_tpu.models import generate as jgen
from any4_tpu.models import llama as jllama
from any4_tpu.quant import api as japi
from any4_tpu_torch import convert
from any4_tpu_torch.models import checkpoint, generate, llama
from any4_tpu_torch.quant import api
from test_torch_convert import assert_close_max, jax_to_numpy

GEMMA2 = dict(hidden_act="gelu_pytorch_tanh", rms_norm_offset=1.0,
              embed_scale=8.0, query_pre_attn_scalar=16.0,
              attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
              sliding_window=4, sandwich_norms=True, tie_word_embeddings=True)
CONFIGS = {"llama": {}, "gemma2": GEMMA2}


def _configs(name, dtype="float32", **over):
    kw = {**CONFIGS[name], **over}
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), **kw,
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(), **kw,
                               dtype=getattr(torch, dtype))
    return jcfg, tcfg


def _ids(b=2, t=12, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _jax_logits(params, cfg, ids):
    return np.asarray(jllama.forward(params, cfg, jnp.asarray(ids),
                                     interpret=True)[0].astype(jnp.float32))


def _port_logits(params, cfg, ids):
    return llama.forward(params, cfg, torch.from_numpy(ids))[0].float()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dense_forward_matches_jax(name):
    jcfg, tcfg = _configs(name)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    ids = _ids(t=10)
    assert_close_max(_port_logits(convert.from_jax_params(
        jax_to_numpy(jp), device="cpu"), tcfg, ids),
        _jax_logits(jp, jcfg, ids), 1e-4)


def test_kv_cache_decode_matches_full_forward():
    jcfg, tcfg = _configs("gemma2")
    params = convert.from_jax_params(jax_to_numpy(
        jllama.init_params(jcfg, jax.random.PRNGKey(1))), device="cpu")
    ids = torch.from_numpy(_ids(b=1, t=9))
    full = llama.forward(params, tcfg, ids)[0][:, -1].float()
    caches = llama.init_kv_caches(tcfg, 1, 12, device="cpu")
    generate.prefill(params, tcfg, ids[:, :8], caches)
    step, _ = generate.decode_step(params, tcfg, ids[:, 8], 8, caches)
    assert_close_max(step.float(), full.numpy(), 1e-5)


@pytest.fixture(scope="module")
def any4_pair():
    """A tiny float32 Llama quantized to any4 by the JAX package (g=128: the
    64-wide layers get whole-row groups and run kernel B, down_proj runs
    kernel A), and the same weights in the port."""
    jcfg, tcfg = _configs("llama", dtype="float32")
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    jq = japi.quantize_model(dense, fmt="any4", group_size=128,
                             kmeans_iters=5)
    return jcfg, tcfg, jq, convert.from_jax_params(jax_to_numpy(jq),
                                                   device="cpu")


def test_any4_logits_match_jax(any4_pair):
    jcfg, tcfg, jq, tq = any4_pair
    kinds = {tq["layers"][0][k].fmt for k in ("q_proj", "down_proj")}
    assert kinds == {"any4", "any4t"}
    ids = _ids(t=12, seed=3)
    assert_close_max(_port_logits(tq, tcfg, ids), _jax_logits(jq, jcfg, ids),
                     2e-2)


def test_any4_greedy_tokens_match_jax(any4_pair):
    jcfg, tcfg, jq, tq = any4_pair
    ids = _ids(b=2, t=6, seed=4)
    ref = np.asarray(jgen.generate(jq, jcfg, jnp.asarray(ids),
                                   max_new_tokens=8))
    out = generate.generate(tq, tcfg, torch.from_numpy(ids),
                            max_new_tokens=8, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_quantize_model_nf4_init_matches_jax():
    jcfg, tcfg = _configs("llama", dtype="bfloat16")
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    jq = japi.quantize_model(dense, fmt="any4", group_size=128,
                             init="nf4", kmeans_iters=4)
    tq = api.quantize_model(convert.from_jax_params(jax_to_numpy(dense),
                                                    device="cpu"),
                            fmt="any4", group_size=128, init="nf4",
                            kmeans_iters=4, device="cpu")
    for jl, tl in zip(jq["layers"], tq["layers"]):
        for key in ("q_proj", "down_proj"):
            ref = convert.qt_from_jax(jax_to_numpy(jl[key]), device="cpu")
            assert tl[key].fmt == ref.fmt
            np.testing.assert_allclose(tl[key].lut.numpy(), ref.lut.numpy(),
                                       atol=1e-4, rtol=0)
    ids = _ids(t=8, seed=6)
    assert_close_max(_port_logits(tq, tcfg, ids), _jax_logits(jq, jcfg, ids),
                     2e-2)


def test_quantize_model_options():
    _, tcfg = _configs("llama", tie_word_embeddings=False)
    params = llama.init_params(tcfg, seed=0, device="cpu")
    q = api.quantize_model(params, fmt="nf4", device="cpu", init="int",
                           sample_weight=lambda name: torch.ones(64))
    assert isinstance(q["lm_head"], torch.Tensor)          # skipped
    assert q["layers"][0]["q_proj"].fmt == "nf4"           # 64-wide: row
    assert q["layers"][1]["down_proj"].fmt == "nf4t"
    assert params["layers"][0]["q_proj"].dtype == torch.float32  # unchanged
    pseudo = api.quantize_model(params, fmt="nf4", pseudo=True, device="cpu")
    np.testing.assert_array_equal(
        pseudo["layers"][0]["q_proj"].numpy(),
        api.dequantize_model(q)["layers"][0]["q_proj"].numpy())
    assert api.model_size_bytes(q) < 2 * api.model_size_bytes(params)
    seen = []       # per-layer online calibration: one call per layer
    api.quantize_model(params, fmt="nf4", device="cpu",
                       calibrate_fn=lambda **kw: seen.append(kw))
    assert seen[0] == {"layers": ["layers.0.q_proj"], "seed": 0}
    assert [kw["seed"] for kw in seen] == list(range(14))
    qe = api.quantize_model(params, quantize_embeddings=True, device="cpu")
    assert qe["embed_tokens"].fmt == "any4"            # row layout


def test_checkpoint_jax_to_port(any4_pair, tmp_path):
    jcfg, tcfg, jq, tq = any4_pair
    jckpt.save_params(str(tmp_path), jq, jcfg)
    params, cfg = checkpoint.load_params(str(tmp_path), device="cpu")
    assert cfg == tcfg
    ids = _ids(t=7, seed=7)
    np.testing.assert_array_equal(_port_logits(params, cfg, ids).numpy(),
                                  _port_logits(tq, tcfg, ids).numpy())


def test_checkpoint_port_to_jax(any4_pair, tmp_path):
    jcfg, tcfg, jq, tq = any4_pair
    checkpoint.save_params(str(tmp_path), tq, tcfg)
    jparams, jcfg2 = jckpt.load_params(str(tmp_path))
    assert jcfg2 == jcfg
    ids = _ids(t=7, seed=8)
    np.testing.assert_array_equal(_jax_logits(jparams, jcfg2, ids),
                                  _jax_logits(jq, jcfg, ids))
    back, _ = checkpoint.load_params(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(_port_logits(back, tcfg, ids).numpy(),
                                  _port_logits(tq, tcfg, ids).numpy())


def test_checkpoint_dense_bf16_round_trip(tmp_path):
    jcfg, tcfg = _configs("gemma2", dtype="bfloat16")
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(9))
    tp = convert.from_jax_params(jax_to_numpy(jp), device="cpu")
    checkpoint.save_params(str(tmp_path), tp, tcfg)
    back, cfg = checkpoint.load_params(str(tmp_path), device="cpu")
    assert cfg == tcfg
    assert back["embed_tokens"].dtype == torch.bfloat16
    ref = jax_to_numpy(jp)
    np.testing.assert_array_equal(convert.to_jax_numpy(back)["layers"][1]
                                  ["v_proj"], ref["layers"][1]["v_proj"])
    jback, _ = jckpt.load_params(str(tmp_path))
    np.testing.assert_array_equal(jax_to_numpy(jback)["norm"], ref["norm"])


def test_generate_options():
    _, tcfg = _configs("llama")
    params = llama.init_params(tcfg, seed=1, device="cpu")
    ids = torch.from_numpy(_ids(b=3, t=5, seed=10))
    greedy = generate.generate(params, tcfg, ids, max_new_tokens=6,
                               device="cpu")
    assert greedy.shape == (3, 11) and greedy.dtype == torch.int32
    eos = int(greedy[0, 6])
    out = generate.generate(params, tcfg, ids, max_new_tokens=6,
                            eos_token_id=eos, device="cpu")
    assert bool((out[0, 6:] == eos).all())      # eos repeats once produced
    s1 = generate.generate(params, tcfg, ids, max_new_tokens=6,
                           temperature=0.7, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    s2 = generate.generate(params, tcfg, ids, max_new_tokens=6,
                           temperature=0.7, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(s1, s2)
    with pytest.raises(ValueError, match="params are on cpu"):
        generate.generate(params, tcfg, ids, device="meta")
