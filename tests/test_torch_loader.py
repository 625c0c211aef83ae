"""The port's loaders and converters (``any4_tpu_torch.models.loader``,
``opt.load_hf_opt``) against random-init ``transformers`` models, on the
CPU.

Each model is built from a small config with a fixed torch seed; its
float32 logits are the reference, as in ``tests/test_hf_parity.py``. Bars:
the port's forward of a converted model within 2e-4 * max|HF logits| (4e-4
for Gemma2, as there), Mixtral's cached decode as well; a checkpoint
written by ``save_pretrained`` (one file, or shards with an index) loads
into the same tree the converter gives, bit for bit, and into the same
config as the JAX package's loader reads.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from any4_tpu.models import loader as jloader
from any4_tpu_torch.models import generate, llama, loader, mixtral, opt
from test_torch_convert import assert_close_max

transformers = pytest.importorskip("transformers")


def _f32(cfg):
    return dataclasses.replace(cfg, dtype=torch.float32)


def _hf_logits(model, ids):
    with torch.no_grad():
        return model(input_ids=torch.from_numpy(ids).long()).logits.float()


def _ids(t=8, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (1, t)).astype(
        np.int64)


def _hf_llama(seed=0, **kw):
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=128, attn_implementation="eager", **kw)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval().float()


def _hf_mixtral(seed=0):
    cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=128, num_local_experts=4,
        num_experts_per_tok=2, attn_implementation="eager",
        router_jitter_noise=0.0)
    torch.manual_seed(seed)
    return transformers.MixtralForCausalLM(cfg).eval().float()


def _hf_opt(seed=0):
    cfg = transformers.OPTConfig(
        vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64,
        word_embed_proj_dim=64, do_layer_norm_before=True)
    torch.manual_seed(seed)
    model = transformers.OPTForCausalLM(cfg).eval().float()
    with torch.no_grad():   # LayerNorms and biases away from 1 and 0
        for name, p in model.named_parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn_like(p))
    return model


def _hf_gemma2(seed=0):
    cfg = transformers.Gemma2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128, sliding_window=4,
        query_pre_attn_scalar=16, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, attn_implementation="eager")
    torch.manual_seed(seed)
    return transformers.Gemma2ForCausalLM(cfg).eval().float()


LLAMAS = {
    "gqa_tied": dict(tie_word_embeddings=True),
    "untied": dict(tie_word_embeddings=False),
    "llama3_rope": dict(rope_theta=500000.0, head_dim=16),
    "attention_bias": dict(attention_bias=True),
}


@pytest.mark.parametrize("name", sorted(LLAMAS))
def test_llama_logits_match_hf(name):
    model = _hf_llama(seed=sorted(LLAMAS).index(name), **LLAMAS[name])
    cfg, params = loader.convert_torch_llama(model, torch.float32, "cpu")
    assert ("lm_head" in params) == (name != "gqa_tied")
    assert ("q_bias" in params["layers"][0]) == (name == "attention_bias")
    ids = _ids(seed=1)
    got, _ = llama.forward(params, _f32(cfg), torch.from_numpy(ids))
    assert_close_max(got, _hf_logits(model, ids).numpy(), 2e-4)


def test_gemma2_logits_match_hf():
    model = _hf_gemma2(seed=10)
    cfg, params = loader.convert_torch_llama(model, torch.float32, "cpu")
    assert cfg.sandwich_norms and cfg.sliding_window == 4
    ids = _ids(t=10, seed=2)
    got, _ = llama.forward(params, _f32(cfg), torch.from_numpy(ids))
    assert_close_max(got, _hf_logits(model, ids).numpy(), 4e-4)


def test_mixtral_logits_and_cached_decode_match_hf():
    model = _hf_mixtral(seed=6)
    cfg, params = loader.convert_torch_mixtral(model, torch.float32, "cpu")
    cfg = _f32(cfg)
    assert isinstance(cfg, mixtral.MixtralConfig)
    assert (cfg.num_local_experts, cfg.num_experts_per_tok) == (4, 2)
    ids = _ids(t=8, seed=3)
    ref = _hf_logits(model, ids).numpy()
    got, _ = mixtral.forward(params, cfg, torch.from_numpy(ids))
    assert_close_max(got, ref, 2e-4)
    caches = llama.init_kv_caches(cfg, 1, 8, device="cpu")
    tids = torch.from_numpy(ids)
    logits, _ = generate.prefill(params, cfg, tids[:, :3], caches)
    assert_close_max(logits, ref[:, 2], 2e-4)
    for t in range(3, 8):
        logits, _ = generate.decode_step(params, cfg, tids[:, t], t, caches)
        assert_close_max(logits, ref[:, t], 2e-4)


def test_opt_logits_match_hf():
    """The pre-LayerNorm layout. (HF's post-LayerNorm OPT has no final
    LayerNorm, which the JAX package's forward and tree require; its
    parity is held against JAX in test_torch_opt.py.)"""
    model = _hf_opt(seed=5)
    cfg, params = loader.convert_torch_opt(model, torch.float32, "cpu")
    assert cfg.do_layer_norm_before
    ids = _ids(t=9, seed=4)
    got, _ = opt.forward(params, _f32(cfg), torch.from_numpy(ids))
    assert_close_max(got, _hf_logits(model, ids).numpy(), 2e-4)


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("kind,shard", [("llama", None), ("mixtral", None),
                                        ("mixtral", "100KB"),
                                        ("opt", None), ("opt", "50KB")])
def test_save_pretrained_round_trip(kind, shard, tmp_path):
    """Shards written by ``save_pretrained`` load into the converter's tree
    (bf16, bit for bit), give HF's logits in float32, and ``load_model``
    picks the family by ``model_type``."""
    model = {"llama": lambda: _hf_llama(seed=7, tie_word_embeddings=False),
             "mixtral": lambda: _hf_mixtral(seed=8),
             "opt": lambda: _hf_opt(seed=9)}[kind]()
    kw = {"max_shard_size": shard} if shard else {}
    model.save_pretrained(tmp_path, safe_serialization=True, **kw)
    assert (tmp_path / "model.safetensors.index.json").exists() == \
        (shard is not None)
    if kind == "opt":
        load, convert, fwd = opt.load_hf_opt, loader.convert_torch_opt, \
            opt.forward
    elif kind == "mixtral":
        load, convert, fwd = loader.load_mixtral, \
            loader.convert_torch_mixtral, mixtral.forward
    else:
        load, convert, fwd = loader.load_llama, loader.convert_torch_llama, \
            llama.forward
    cfg, params = load(str(tmp_path), device="cpu")
    ccfg, cparams = convert(model, device="cpu")
    assert cfg == ccfg
    _assert_trees_equal(params, cparams)
    cfg32, p32 = load(str(tmp_path), dtype=torch.float32, device="cpu")
    ids = _ids(t=6, seed=10)
    got, _ = fwd(p32, _f32(cfg32), torch.from_numpy(ids))
    assert_close_max(got, _hf_logits(model, ids).numpy(), 2e-4)
    if kind != "opt":
        mcfg, mparams = loader.load_model(str(tmp_path), torch.float32,
                                          device="cpu")
        assert mcfg == cfg32
        _assert_trees_equal(mparams, p32)
        jcfg = (jloader._mixtral_cfg_from_hf if kind == "mixtral"
                else jloader._cfg_from_hf)(
            json.loads((tmp_path / "config.json").read_text()))
        assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                if f.name != "dtype"} == \
            {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
             if f.name != "dtype"}


def test_as_numpy_and_load_hf_torch_model(tmp_path):
    model = _hf_mixtral(seed=11)
    model.save_pretrained(tmp_path, safe_serialization=True)
    cfg, host = loader.load_model(str(tmp_path), as_numpy=True)
    router = host["layers"][1]["router"]
    assert isinstance(router, np.ndarray) and router.dtype == np.float32
    np.testing.assert_array_equal(
        router, model.model.layers[1].block_sparse_moe.gate.weight
        .detach().numpy())
    cfg2, params = loader.load_hf_torch_model(str(tmp_path), torch.float32,
                                              device="cpu")
    assert isinstance(cfg2, mixtral.MixtralConfig) and cfg2 == cfg
    np.testing.assert_array_equal(
        params["layers"][0]["experts"][3]["w2"].numpy(),
        host["layers"][0]["experts"][3]["w2"])


@pytest.mark.parametrize("config", [
    dict(model_type="llama", vocab_size=100, hidden_size=32,
         intermediate_size=64, num_hidden_layers=2, num_attention_heads=4),
    dict(model_type="qwen2", vocab_size=100, hidden_size=32,
         intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
         num_key_value_heads=2, rope_theta=1e6, tie_word_embeddings=True,
         attention_bias=True),
    dict(model_type="gemma", vocab_size=100, hidden_size=32,
         intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
         head_dim=16, hidden_activation="gelu_pytorch_tanh"),
    dict(model_type="gemma2", vocab_size=100, hidden_size=32,
         intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
         query_pre_attn_scalar=8, attn_logit_softcapping=50.0,
         final_logit_softcapping=30.0, sliding_window=4,
         layer_types=["sliding_attention", "full_attention",
                      "sliding_attention"]),
    dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
         intermediate_size=14336, num_hidden_layers=32,
         num_attention_heads=32, num_key_value_heads=8, rope_theta=1e6,
         max_position_embeddings=32768, rms_norm_eps=1e-5,
         tie_word_embeddings=False, num_local_experts=8,
         num_experts_per_tok=2)])
def test_cfg_from_hf_matches_jax(config):
    fn = "_mixtral_cfg_from_hf" if config["model_type"] == "mixtral" \
        else "_cfg_from_hf"
    got = getattr(loader, fn)(config)
    want = getattr(jloader, fn)(config)
    assert type(got).__name__ == type(want).__name__
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.dtype == torch.bfloat16
