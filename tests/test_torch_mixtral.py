"""The port's Mixtral (``any4_tpu_torch.models.mixtral``), its ``generate``
and its engine against the JAX package, on the CPU.

Parameters are made by the JAX package from a seed and carried across with
``convert.from_jax_params(..., device="cpu")``; inputs are made by numpy
from a seed. Bars:
- dense float32 logits within 1e-4 * max|ref|, prefill and cached decode;
- ``moe_ffn`` in its three layouts (per-expert, ``w13``-fused, stacked)
  within 1e-4 * max of JAX's;
- sparse dispatch equal to dense bit for bit;
- equal router logits: the lower expert index first, as ``jax.lax.top_k``;
- int4/any4 models within 2e-2 * max of JAX's interpreted kernels, with
  equal greedy tokens;
- the port's engine on the stacked and the unstacked any4 model against
  the port's ``generate`` by ``test_torch_engine.py``'s tie rule
  (``QUANT_TIE``), and on the dense float32 model token for token against
  the JAX engine.

The quantized model is 128 wide with an FFN of 256, so that every linear
is ``any4t`` or ``int4p`` at g=128 (kernel A's and C's plain versions).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.models import fuse as jfuse
from any4_tpu.models import generate as jgen
from any4_tpu.models import mixtral as jmixtral
from any4_tpu.quant import api as japi
from any4_tpu_torch import convert
from any4_tpu_torch.models import fuse, generate, llama, mixtral
from any4_tpu_torch.serving import engine as teng
from test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from test_torch_convert import assert_close_max, jax_to_numpy
from test_torch_engine import QUANT_TIE, _both, _prompts, _serve

WIDE = dict(hidden_size=128, intermediate_size=256)


def _configs(dtype="float32", **over):
    jcfg = dataclasses.replace(jmixtral.MixtralConfig.tiny(), **over,
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(mixtral.MixtralConfig.tiny(), **over,
                               dtype=getattr(torch, dtype))
    return jcfg, tcfg


def _port(tree):
    return convert.from_jax_params(jax_to_numpy(tree), device="cpu")


def _ids(b=2, t=10, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _jax_logits(params, cfg, ids):
    return np.asarray(jmixtral.forward(params, cfg, jnp.asarray(ids))[0],
                      np.float32)


def _port_logits(params, cfg, ids):
    return mixtral.forward(params, cfg, torch.from_numpy(ids))[0].float()


@pytest.fixture(scope="module")
def dense():
    jcfg, tcfg = _configs()
    jp = jmixtral.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, _port(jp)


def test_dense_forward_matches_jax(dense):
    jcfg, tcfg, jp, tp = dense
    ids = _ids()
    assert_close_max(_port_logits(tp, tcfg, ids), _jax_logits(jp, jcfg, ids),
                     1e-4)


def test_cached_decode_matches_jax(dense):
    """Prefill of 5 tokens, then single-token decode steps (b=1: sparse
    dispatch), against JAX's full forward at each position."""
    jcfg, tcfg, jp, tp = dense
    ids = _ids(b=1, t=9, seed=1)
    ref = _jax_logits(jp, jcfg, ids)
    caches = llama.init_kv_caches(tcfg, 1, 9, device="cpu")
    tids = torch.from_numpy(ids).long()
    logits, _ = generate.prefill(tp, tcfg, tids[:, :5], caches)
    assert_close_max(logits.float(), ref[:, 4], 1e-4)
    for t in range(5, 9):
        logits, _ = generate.decode_step(tp, tcfg, tids[:, t], t, caches)
        assert_close_max(logits.float(), ref[:, t], 1e-4)


def _layouts(jlayer, tlayer):
    """``{layout: (JAX layer, port layer)}`` for the three expert
    layouts, each made by its package's ``fuse``."""
    out = {"experts": (jlayer, tlayer)}
    jf = jfuse.fuse_projections({"layers": [jlayer]})["layers"][0]
    tf = fuse.fuse_projections({"layers": [tlayer]})["layers"][0]
    assert "w13" in tf["experts"][0] and "w1" not in tf["experts"][0]
    out["w13"] = (jf, tf)
    out["stacked"] = (jfuse.stack_experts({"layers": [jlayer]})["layers"][0],
                      fuse.stack_experts({"layers": [tlayer]})["layers"][0])
    return out


@pytest.mark.parametrize("layout", ["experts", "w13", "stacked"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (1, 9)])
def test_moe_ffn_layouts_match_jax(dense, layout, shape):
    jcfg, tcfg, jp, tp = dense
    jl, tl = _layouts(jp["layers"][0], tp["layers"][0])[layout]
    x = np.random.default_rng(2).standard_normal(
        (*shape, jcfg.hidden_size)).astype(np.float32)
    ref = np.asarray(jmixtral.moe_ffn(jl, jcfg, jnp.asarray(x)))
    got = mixtral.moe_ffn(tl, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert_close_max(got, ref, 1e-4)


@pytest.fixture(scope="module")
def any4_pair():
    """The 128-wide float32 model quantized to any4 by the JAX package, in
    both packages, unstacked and (stacked before quantization) stacked."""
    jcfg, tcfg = _configs(**WIDE)
    jp = jmixtral.init_params(jcfg, jax.random.PRNGKey(3))
    jq = japi.quantize_model(jp, fmt="any4", group_size=128, kmeans_iters=5)
    jst = japi.quantize_model(jfuse.stack_experts(jp), fmt="any4",
                              group_size=128, kmeans_iters=5)
    return jcfg, tcfg, {"experts": (jq, _port(jq)),
                        "stacked": (jst, _port(jst))}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (3, 1), (2, 5)])
def test_sparse_equals_dense_bit_for_bit(any4_pair, dense, quantized, dtype,
                                         shape):
    if quantized:
        _, tcfg, pairs = any4_pair
        layer = pairs["experts"][1]["layers"][1]
    else:
        _, tcfg, _, tp = dense
        layer = tp["layers"][1]
    tcfg = dataclasses.replace(tcfg, dtype=getattr(torch, dtype))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (*shape, tcfg.hidden_size)).astype(np.float32)).to(tcfg.dtype)
    if not quantized:
        layer = {k: v if k == "experts" else v.to(tcfg.dtype)
                 for k, v in layer.items()}
        layer["experts"] = [{k: w.to(tcfg.dtype) for k, w in e.items()}
                            for e in layer["experts"]]
    sparse = mixtral.moe_ffn(layer, tcfg, x, dispatch="sparse")
    dense_out = mixtral.moe_ffn(layer, tcfg, x, dispatch="dense")
    assert sparse.dtype == tcfg.dtype
    assert torch.equal(sparse, dense_out)
    auto = mixtral.moe_ffn(layer, tcfg, x)
    assert torch.equal(auto, dense_out)


def test_moe_ffn_sparse_runs_only_routed_experts(dense, monkeypatch):
    """Sparse dispatch reads the routed set and runs only those experts'
    linears; dense runs every expert; auto is sparse at b * t * k <= E/2."""
    _, tcfg, _, tp = dense
    layer = tp["layers"][0]
    calls = []
    orig = mixtral.lin.linear

    def counted(x, w, *a, **kw):
        calls.append(w.shape)
        return orig(x, w, *a, **kw)

    monkeypatch.setattr(mixtral.lin, "linear", counted)
    x = torch.randn((1, 1, tcfg.hidden_size),
                    generator=torch.Generator().manual_seed(0))
    topi, _ = mixtral.route(layer, tcfg, x)
    for dispatch, experts in (("sparse", len(set(topi.flatten().tolist()))),
                              ("auto", 2), ("dense", 4)):
        calls.clear()
        mixtral.moe_ffn(layer, tcfg, x, dispatch=dispatch)
        assert len(calls) == 1 + 3 * experts            # router + 3 each
    assert mixtral._sparse_pays(1, 2, 4) and not mixtral._sparse_pays(2, 2, 4)


def test_router_ties_pick_the_lower_index_like_jax(dense):
    """Two identical router rows give equal logits; both packages pick the
    lower expert first and give the same outputs."""
    jcfg, tcfg, jp, tp = dense
    router = np.array(jax_to_numpy(jp["layers"][0]["router"]))
    router[1] = router[3] = router[0] * 4.0          # 1 and 3 tie, on top
    jl = {**jp["layers"][0], "router": jnp.asarray(router)}
    tl = {**tp["layers"][0], "router": torch.from_numpy(router)}
    x = np.abs(np.random.default_rng(5).standard_normal(
        (2, 3, jcfg.hidden_size))).astype(np.float32)
    x *= np.sign(router[0])[None, None]              # router[0] . x > 0
    logits = torch.from_numpy(x) @ torch.from_numpy(router).t()
    assert torch.equal(logits[..., 1], logits[..., 3])
    topi, gate = mixtral.route(tl, tcfg, torch.from_numpy(x))
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    assert (topi[..., 0] == 1).all() and (topi[..., 1] == 3).all()
    np.testing.assert_allclose(gate.numpy(), 0.5)
    for dispatch in ("dense", "sparse"):
        assert_close_max(
            mixtral.moe_ffn(tl, tcfg, torch.from_numpy(x), dispatch=dispatch),
            np.asarray(jmixtral.moe_ffn(jl, jcfg, jnp.asarray(x),
                                        dispatch=dispatch)), 1e-4)


@pytest.mark.parametrize("fmt,kinds", [("any4", {"any4t"}),
                                       ("int4", {"int4p"})])
def test_quantized_logits_and_tokens_match_jax(any4_pair, fmt, kinds):
    """The port's greedy tokens, then one JAX forward over the prompt and
    those tokens: every token is JAX's argmax after the same prefix (so
    JAX's greedy decode gives the same tokens), and the logits agree within
    2e-2 * max."""
    jcfg, tcfg, pairs = any4_pair
    if fmt == "any4":
        jq, tq = pairs["experts"]
    else:
        jp = jmixtral.init_params(jcfg, jax.random.PRNGKey(6))
        jq = japi.quantize_model(jp, fmt=fmt, group_size=128)
        tq = _port(jq)
    assert {e[w].fmt for l in tq["layers"] for e in l["experts"]
            for w in ("w1", "w2", "w3")} | {tq["layers"][0]["q_proj"].fmt} \
        == kinds
    assert isinstance(tq["layers"][0]["router"], torch.Tensor)
    prompt = _ids(b=2, t=5, seed=8)
    out = generate.generate(tq, tcfg, torch.from_numpy(prompt),
                            max_new_tokens=6, device="cpu").numpy()
    seq = out[:, :-1]
    ref = _jax_logits(jq, jcfg, seq)
    assert_close_max(_port_logits(tq, tcfg, seq), ref, 2e-2)
    np.testing.assert_array_equal(ref[:, 4:].argmax(-1), out[:, 5:])


def test_generate_picks_the_mixtral_forward(dense):
    jcfg, tcfg, jp, tp = dense
    assert generate._model_forward(tp) is mixtral.forward
    assert generate._model_forward(
        fuse.stack_experts(tp)) is mixtral.forward
    assert generate._model_forward(
        llama.init_params(llama.LlamaConfig.tiny(), device="cpu")) \
        is llama.forward
    prompt = _ids(b=2, t=4, seed=9)
    ref = np.asarray(jgen.generate(jp, jcfg, jnp.asarray(prompt),
                                   max_new_tokens=5))
    out = generate.generate(tp, tcfg, torch.from_numpy(prompt),
                            max_new_tokens=5, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def _engine_against_generate(params, cfg, prompts, max_new, tie, **kw):
    """The port's engine on ``prompts`` against the port's ``generate`` on
    each prompt alone: tokens equal up to the first position where
    generate's two best logits (teacher-forced along its tokens) are
    closer than ``tie * max|logit|``; there the engine's token is one of
    those within that distance of the top."""
    got, e = _serve(teng, params, cfg, prompts, max_new, **kw)
    for p, g in zip(prompts, got):
        want = generate.generate(params, cfg, torch.from_numpy(p[None]),
                                 max_new_tokens=max_new,
                                 device="cpu")[0, len(p):].tolist()
        assert len(g) == len(want) == max_new
        seq = np.concatenate([p, np.asarray(want[:-1], np.int32)])
        logits = _port_logits(params, cfg, seq[None])[0, len(p) - 1:].numpy()
        for i, (gt, wt) in enumerate(zip(g, want)):
            span = tie * np.abs(logits[i]).max()
            top = np.sort(logits[i])[::-1]
            if top[0] - top[1] < span:
                assert logits[i][gt] >= top[0] - span
                break
            assert gt == wt
    return got, e


@pytest.mark.parametrize("layout", ["experts", "stacked"])
@pytest.mark.parametrize("kv", [dict(run=dict(burst=4)),
                                dict(kv_layout="contig", run=dict(
                                    burst=2, pipeline=True))])
def test_engine_matches_generate(any4_pair, layout, kv):
    _, tcfg, pairs = any4_pair
    tq = pairs[layout][1]
    assert ("moe_w13" in tq["layers"][0]) == (layout == "stacked")
    got, e = _engine_against_generate(tq, tcfg, _prompts(2, (4, 9, 6)), 6,
                                      QUANT_TIE, max_slots=2, max_ctx=32,
                                      page_size=8, **kv)
    assert not e.seq_lens.any()


def test_engine_dense_matches_jax_engine(dense):
    jcfg, tcfg, jp, tp = dense
    pair = (jp, jcfg, tp, tcfg)
    _both(pair, _prompts(3, (4, 7, 5)), 5, max_slots=2, max_ctx=32,
          page_size=8, run=dict(burst=4))


def test_engine_decode_uses_dense_dispatch(dense, monkeypatch):
    """The engine's decode step never reads the routed set to the host."""
    _, tcfg, _, tp = dense
    seen = []
    orig = mixtral.moe_ffn

    def spy(layer, cfg, x, dispatch="auto", **kw):
        seen.append(dispatch)
        return orig(layer, cfg, x, dispatch=dispatch, **kw)

    monkeypatch.setattr(mixtral, "moe_ffn", spy)
    e = teng.Engine(tp, tcfg, max_slots=1, max_ctx=32, page_size=8,
                    device="cpu")
    e.submit(_prompts(4, (3,))[0], max_new_tokens=3)
    e.run()
    assert seen.count("dense") == 2 * tcfg.num_hidden_layers   # 2 steps
    assert set(seen) == {"auto", "dense"}                      # prefill auto


def test_init_params_shapes():
    cfg = mixtral.MixtralConfig.tiny()
    p = mixtral.init_params(cfg, seed=0, device="cpu")
    layer = p["layers"][0]
    assert "gate_proj" not in layer and layer["router"].shape == (4, 64)
    assert [tuple(layer["experts"][0][w].shape) for w in ("w1", "w3", "w2")] \
        == [(96, 64), (96, 64), (64, 96)]
    assert layer["experts"][0]["w1"].dtype == torch.bfloat16
    again = mixtral.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"][1]["experts"][3]["w2"],
                       p["layers"][1]["experts"][3]["w2"])
    assert not torch.equal(layer["experts"][0]["w1"],
                           layer["experts"][1]["w1"])
    logits, _ = mixtral.forward(p, cfg, torch.zeros((1, 3),
                                                    dtype=torch.long))
    assert logits.shape == (1, 3, 256) and bool(torch.isfinite(logits).all())
