"""The int8-weight slice as a whole on the CPU: a 2-layer Llama (hidden 256,
intermediate 4096, so that down_proj's k = 4096 takes the grouped ``g``
route and the other six linears the ``q`` route), quantized by the port's
``quantize_model`` and by the JAX package's from the same float32 weights,
as ``int8``, ``w8a8`` and ``any4q8`` (deterministic k-means init) at
g=128, and as ``int8`` at g=64, which keeps every linear in the row
layout (``int8_fused``).

Bars: int8 and w8a8 weights equal JAX's field for field, any4q8's snapped
codes at least 99.9% equal with scales within 1e-4 relative; logits within
2e-2 * max|ref| of JAX's (the repo's kernel bar) at 24 rows (the kernel
routes) and 136 rows (down_proj dequantized); greedy tokens equal over 8 new
tokens and checkpoints loading in either package with the same logits, on
JAX's weights carried across.
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
from any4_tpu_torch.ops import gemv, linear as tlin
from any4_tpu_torch.quant import api
from test_torch_convert import assert_close_max, jax_to_numpy

WIDTHS = dict(hidden_size=256, intermediate_size=4096, num_hidden_layers=2)
# model -> quantize_model's arguments besides fmt=model and group_size=128
MODELS = {"int8": {}, "w8a8": {},
          "any4q8": dict(init="int", kmeans_iters=3),
          "int8_g64": dict(fmt="int8", group_size=64)}
# model -> format of the six k = 256 linears, of down_proj (k = 4096)
KINDS = {"int8": ("int8q", "int8g"), "w8a8": ("w8a8q", "w8a8g"),
         "any4q8": ("any4q8", "any4q8g"), "int8_g64": ("int8", "int8")}
LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
           "down_proj")
# the plain versions each forward calls, by model and rows per forward
PLAINS = {
    ("int8", 24): {"int8_post_plain": 14},
    ("int8", 136): {"int8_post_plain": 12},
    ("w8a8", 24): {"w8a8_fused_plain": 12, "w8a8_plain": 2},
    ("w8a8", 136): {"w8a8_plain": 12},
    ("int8_g64", 24): {"int8_fused_plain": 14},
    ("int8_g64", 136): {"int8_fused_plain": 14},
}


def _ids(b=2, t=12, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


@pytest.fixture(scope="module", params=sorted(MODELS))
def models(request):
    fmt = request.param
    kw = {"fmt": fmt, "group_size": 128, **MODELS[fmt]}
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), **WIDTHS,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(), **WIDTHS,
                               dtype=torch.float32)
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    jq = japi.quantize_model(dense, **kw)
    own = api.quantize_model(
        convert.from_jax_params(jax_to_numpy(dense), device="cpu"),
        device="cpu", **kw)
    carried = convert.from_jax_params(jax_to_numpy(jq), device="cpu")
    return fmt, jcfg, tcfg, jq, own, carried


def test_weights_equal_jax(models):
    fmt, _, _, _, own, carried = models
    for ol, cl in zip(own["layers"], carried["layers"]):
        for key in LINEARS:
            got, ref = ol[key], cl[key]
            kind = KINDS[fmt][key == "down_proj"]
            assert got.fmt == ref.fmt == kind and got.lut is None
            assert got.packed.dtype == torch.int8
            if fmt == "any4q8":
                equal = float((got.packed == ref.packed).float().mean())
                assert equal >= 0.999, (key, equal)
                np.testing.assert_allclose(got.scales.numpy(),
                                           ref.scales.numpy(), rtol=1e-4)
                continue
            for f in ("packed", "scales", "zeros"):
                assert torch.equal(getattr(got, f), getattr(ref, f)), (key, f)


@pytest.mark.parametrize("b,t", [(2, 12), (1, 136)])
def test_logits_match_jax(models, b, t, monkeypatch):
    fmt, jcfg, tcfg, jq, own, _ = models
    ids = _ids(b, t, seed=3)
    ref = np.asarray(jllama.forward(jq, jcfg, jnp.asarray(ids),
                                    interpret=True)[0])
    calls = {}
    for plain in ("w8a8_plain", "w8a8_fused_plain", "int8_post_plain",
                  "int8_fused_plain"):
        orig = getattr(gemv, plain)
        monkeypatch.setattr(gemv, plain, lambda *a, _o=orig, _n=plain:
                            calls.update({_n: calls.get(_n, 0) + 1})
                            or _o(*a))
    got = llama.forward(own, tcfg, torch.from_numpy(ids))[0]
    want = PLAINS[("w8a8" if fmt == "any4q8" else fmt, b * t)]
    assert calls == want
    assert_close_max(got, ref, 2e-2)


def test_greedy_tokens_match_jax(models):
    _, jcfg, tcfg, jq, _, carried = models
    ids = _ids(b=2, t=6, seed=4)
    ref = np.asarray(jgen.generate(jq, jcfg, jnp.asarray(ids),
                                   max_new_tokens=8))
    out = generate.generate(carried, tcfg, torch.from_numpy(ids),
                            max_new_tokens=8, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_checkpoints_both_ways(models, tmp_path):
    fmt, jcfg, tcfg, jq, _, carried = models
    ids = torch.from_numpy(_ids(t=7, seed=7))
    want = llama.forward(carried, tcfg, ids)[0].numpy()
    jckpt.save_params(str(tmp_path / "jax"), jq, jcfg)
    params, cfg = checkpoint.load_params(str(tmp_path / "jax"), device="cpu")
    assert cfg == tcfg
    assert isinstance(params["layers"][1]["down_proj"], tlin.QuantizedTensor)
    np.testing.assert_array_equal(llama.forward(params, cfg, ids)[0].numpy(),
                                  want)
    checkpoint.save_params(str(tmp_path / "port"), carried, tcfg)
    jparams, jcfg2 = jckpt.load_params(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    assert jparams["layers"][0]["down_proj"].fmt == KINDS[fmt][1]
    assert jparams["layers"][0]["q_proj"].lut is None
    x = jnp.asarray(ids.numpy())
    np.testing.assert_array_equal(
        np.asarray(jllama.forward(jparams, jcfg2, x, interpret=True)[0]),
        np.asarray(jllama.forward(jq, jcfg, x, interpret=True)[0]))
