"""Projection fusion (``models/fuse.py``) and quantized tied embeddings in
the port, against the JAX package on the CPU.

- ``concat_quantized`` of parts the JAX package quantized, for every
  format: the port's concatenation of the carried parts equals JAX's
  concatenation carried across, field for field; ``fuse_projections``
  with a partial bias set and ``stack_experts`` on dense experts equal
  JAX's trees.
- A tiny Llama quantized by the JAX package with ``quantize_embeddings``
  and fused: its logits within 2e-2 * max of JAX's fused forward (the any4
  bar of ``test_torch_llama.py``), the fused port model within 1e-3 * max
  of the unfused one with the same greedy tokens (JAX's bar,
  ``tests/test_model.py``), and the engine against JAX's engine on the
  same parameters by ``test_torch_engine.py``'s tie rule (``QUANT_TIE``).
- Checkpoints of the new formats and of a fused tree round-trip through
  both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.models import checkpoint as jckpt
from any4_tpu.models import fuse as jfuse
from any4_tpu.models import llama as jllama
from any4_tpu.ops import linear as jlin
from any4_tpu.quant import api as japi
from any4_tpu_torch import convert
from any4_tpu_torch.models import checkpoint, fuse, generate, llama
from any4_tpu_torch.ops import linear as tlin
from any4_tpu_torch.quant import api
from test_torch_convert import assert_close_max, jax_to_numpy
from test_torch_engine import QUANT_TIE, _both, _prompts

ANY4 = dict(init="int", kmeans_iters=2)
# (fmt, group size, extra quantize_tensor arguments) of the parts
CONCAT_CASES = [
    ("any4", 128, ANY4), ("any4", 128, dict(ANY4, layout="row")),
    ("any4", 64, ANY4), ("nf4", 128, {}), ("fp4", 64, {}), ("mx4", 32, {}),
    ("int4", 128, {}), ("int4", 128, dict(layout="row")), ("w4a8", 128, {}),
    ("int8", 128, {}), ("int8", 64, {}), ("int8t", 128, {}),
    ("int8g", 128, {}), ("int8p", 128, {}), ("w8a8", 128, {}),
    ("w8a8t", 128, {}), ("w8a8g", 128, {}), ("any4q8", 128, ANY4),
    ("any4q8g", 128, ANY4), ("int8r", 128, {}), ("w8a8r", 128, {}),
    ("any4q8r", 128, ANY4),
]


def _w(n, k, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _carry(tree):
    return convert.from_jax_params(jax_to_numpy(tree), device="cpu")


def _assert_qt_equal(a, b):
    assert (a.fmt, a.group_size, a.shape, a.dtype) == \
        (b.fmt, b.group_size, b.shape, b.dtype)
    for f in convert.QT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("fmt,g,kw", CONCAT_CASES,
                         ids=[f"{f}-g{g}-{kw.get('layout', 'default')}"
                              for f, g, kw in CONCAT_CASES])
def test_concat_quantized_matches_jax(fmt, g, kw):
    parts = [jlin.quantize_tensor(jnp.asarray(_w(n, 256, seed=n)), fmt, g,
                                  **kw) for n in (64, 32, 32)]
    want = _carry(jfuse.concat_quantized(parts))
    got = fuse.concat_quantized([_carry(p) for p in parts])
    assert got.shape == (128, 256)
    _assert_qt_equal(got, want)
    x = torch.from_numpy(_w(3, 256, seed=1))
    assert_close_max(tlin.linear(x, got), torch.cat(
        [tlin.linear(x, _carry(p)) for p in parts], dim=1).numpy(), 1e-5)


def test_concat_quantized_refuses_mixed_parts():
    a = tlin.quantize_tensor(torch.from_numpy(_w(32, 256)), "int8r")
    b = tlin.quantize_tensor(torch.from_numpy(_w(32, 256)), "w8a8r")
    with pytest.raises(ValueError, match="must share"):
        fuse.concat_quantized([a, b])


def _layer(seed, biases=()):
    rng = np.random.default_rng(seed)
    d = {k: rng.standard_normal((n, 64)).astype(np.float32)
         for k, n in (("q_proj", 64), ("k_proj", 32), ("v_proj", 32),
                      ("gate_proj", 128), ("up_proj", 128))}
    d["down_proj"] = rng.standard_normal((64, 128)).astype(np.float32)
    for b in biases:
        d[f"{b}_bias"] = rng.standard_normal(d[f"{b}_proj"].shape[0]).astype(
            np.float32)
    return d


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    elif isinstance(want, tlin.QuantizedTensor):
        _assert_qt_equal(got, want)
    else:
        assert torch.equal(got, want)


def test_fuse_projections_partial_bias_matches_jax():
    tree = {"layers": [_layer(0, ("k", "v")), _layer(1),
                       {"norm": np.ones(64, np.float32)}]}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    want = _carry(jfuse.fuse_projections(jtree))
    got = fuse.fuse_projections(_carry(jtree))
    _assert_tree_equal(got, want)
    assert "qkv_bias" in got["layers"][0]
    assert "qkv_bias" not in got["layers"][1]
    assert not bool(got["layers"][0]["qkv_bias"][:64].any())   # q: zeros
    jq = japi.quantize_model(jtree, fmt="int8r")
    _assert_tree_equal(fuse.fuse_projections(_carry(jq)),
                       _carry(jfuse.fuse_projections(jq)))


def test_stack_experts_matches_jax():
    rng = np.random.default_rng(3)

    def expert(w13):
        e = {"w2": rng.standard_normal((64, 128)).astype(np.float32)}
        if w13:
            e["w13"] = rng.standard_normal((256, 64)).astype(np.float32)
        else:
            e["w1"] = rng.standard_normal((128, 64)).astype(np.float32)
            e["w3"] = rng.standard_normal((128, 64)).astype(np.float32)
        return e

    tree = {"layers": [{"experts": [expert(False) for _ in range(3)],
                        "router": rng.standard_normal((3, 64)).astype(
                            np.float32)},
                       {"experts": [expert(True), expert(True)]},
                       {"q_proj": rng.standard_normal((8, 64)).astype(
                           np.float32)}]}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    want = _carry(jfuse.stack_experts(jtree))
    got = fuse.stack_experts(_carry(jtree))
    _assert_tree_equal(got, want)
    assert got["layers"][0]["moe_w13"].shape == (768, 64)
    assert got["layers"][0]["moe_w2"].shape == (64, 384)
    fused = fuse.fuse_projections(_carry(jtree))
    _assert_tree_equal(fused, _carry(jfuse.fuse_projections(jtree)))
    assert "w13" in fused["layers"][0]["experts"][0]


def _configs():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab=256, layers=2),
                               tie_word_embeddings=True, dtype=jnp.float32)
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab=256, layers=2),
                               tie_word_embeddings=True, dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def qemb():
    """A tiny tied Llama quantized by the JAX package to any4 (g=128) with
    its embeddings (the table in the row layout), fused by the JAX
    package, and the same models in the port: ``(jcfg, tcfg, JAX fused,
    port unfused, port fused)``."""
    jcfg, tcfg = _configs()
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    jq = japi.quantize_model(dense, fmt="any4", group_size=128,
                             kmeans_iters=3, quantize_embeddings=True)
    jf = jfuse.fuse_projections(jq)
    return jcfg, tcfg, jf, _carry(jq), _carry(jf)


def _ids(b=2, t=12, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


def test_fused_qemb_logits_match_jax(qemb):
    jcfg, tcfg, jf, tq, tf = qemb
    emb = tf["embed_tokens"]
    assert isinstance(emb, tlin.QuantizedTensor) and emb.fmt == "any4"
    assert all("qkv_proj" in l and "gateup_proj" in l and "q_proj" not in l
               for l in tf["layers"])
    _assert_tree_equal(fuse.fuse_projections(tq), tf)
    ids = _ids()
    want = np.asarray(jllama.forward(jf, jcfg, jnp.asarray(ids),
                                     interpret=True)[0])
    got = llama.forward(tf, tcfg, torch.from_numpy(ids))[0]
    assert_close_max(got, want, 2e-2)
    unfused = llama.forward(tq, tcfg, torch.from_numpy(ids))[0]
    assert_close_max(got, unfused.numpy(), 1e-3)


def test_fused_qemb_generate_matches_unfused(qemb):
    _, tcfg, _, tq, tf = qemb
    ids = torch.from_numpy(_ids(b=2, t=6, seed=4))
    out = generate.generate(tf, tcfg, ids, max_new_tokens=8, device="cpu")
    ref = generate.generate(tq, tcfg, ids, max_new_tokens=8, device="cpu")
    assert torch.equal(out, ref) and out.shape == (2, 14)
    with pytest.raises(ValueError, match="params are on cpu"):
        generate.generate(tf, tcfg, ids)             # default device: cuda


def test_fused_qemb_engine_matches_jax(qemb):
    jcfg, tcfg, jf, _, tf = qemb
    got, e = _both((jf, jcfg, tf, tcfg), _prompts(2, (4, 7, 5)), 5,
                   tie=QUANT_TIE, max_slots=2, max_ctx=32, page_size=8,
                   run=dict(burst=4))
    assert [len(t) for t in got] == [5, 5, 5]
    assert not e.seq_lens.any()


@pytest.mark.parametrize("fmt,efmt,table", [("int8r", "int8", "int8"),
                                            ("w8a8r", "intq", "int4"),
                                            ("mx4", True, "mx4")])
def test_quantize_embeddings_matches_jax(fmt, efmt, table):
    """``quantize_model(quantize_embeddings=...)`` on both packages: the
    same table fields (JAX's carried across), and the fused forward within
    2e-2 * max of JAX's (the repo's kernel bar)."""
    jcfg, tcfg = _configs()
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    g = 32 if fmt == "mx4" else 128
    jq = japi.quantize_model(dense, fmt=fmt, group_size=g,
                             quantize_embeddings=efmt)
    tq = api.quantize_model(_carry(dense), fmt=fmt, group_size=g,
                            quantize_embeddings=efmt, device="cpu")
    want = _carry(jq)
    _assert_qt_equal(tq["embed_tokens"], want["embed_tokens"])
    assert tq["embed_tokens"].fmt == table
    ids = _ids(t=8, seed=5)
    jf = jfuse.fuse_projections(jq)
    ref = np.asarray(jllama.forward(jf, jcfg, jnp.asarray(ids),
                                    interpret=True)[0])
    got = llama.forward(fuse.fuse_projections(tq), tcfg,
                        torch.from_numpy(ids))[0]
    assert_close_max(got, ref, 2e-2)
    with pytest.raises(ValueError, match="row-gatherable"):
        api.quantize_model(_carry(dense), fmt="int4", device="cpu",
                           quantize_embeddings="int4p")


def test_checkpoints_round_trip_new_formats_and_fused(qemb, tmp_path):
    jcfg, tcfg, jf, _, tf = qemb
    extra = {fmt: tlin.quantize_tensor(torch.from_numpy(_w(64, 256, seed=6)),
                                       fmt, 32 if fmt == "mx4" else 128,
                                       **(ANY4 if fmt == "any4q8r" else {}))
             for fmt in ("mx4", "int8p", "int8r", "w8a8r", "any4q8r")}
    tree = {**tf, "extra": extra}
    checkpoint.save_params(str(tmp_path / "port"), tree, tcfg)
    back, cfg = checkpoint.load_params(str(tmp_path / "port"), device="cpu")
    assert cfg == tcfg
    for fmt, qt in extra.items():
        b = back["extra"][fmt]
        assert (b.fmt, b.group_size, b.shape) == (qt.fmt, qt.group_size,
                                                  qt.shape)
        assert torch.equal(b.packed, qt.packed)
        assert_close_max(tlin.dequantize_tensor(b, torch.float32),
                         tlin.dequantize_tensor(qt, torch.float32).numpy(),
                         1e-6 if fmt == "int8p" else 0.0)
    _assert_tree_equal({k: v for k, v in back.items() if k != "extra"}, tf)
    jback, jcfg2 = jckpt.load_params(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    for fmt in extra:
        want = jax_to_numpy(jlin.quantize_tensor(
            jnp.asarray(_w(64, 256, seed=6)), fmt, 32 if fmt == "mx4" else 128,
            **(ANY4 if fmt == "any4q8r" else {})))
        got = jax_to_numpy(jback["extra"][fmt])
        assert got["fmt"] == want["fmt"]
        if fmt != "any4q8r":          # learned: the learner's own bar
            for f in convert.QT_FIELDS:
                if want[f] is not None:
                    np.testing.assert_array_equal(got[f], want[f])
    jckpt.save_params(str(tmp_path / "jax"), jf, jcfg)
    loaded, _ = checkpoint.load_params(str(tmp_path / "jax"), device="cpu")
    _assert_tree_equal(loaded, tf)
