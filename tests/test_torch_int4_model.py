"""The int4 and W4A8 slice as a whole on the CPU: a 2-layer Llama whose
widths are multiples of 128 (W4A8 needs g % 128 == 0), quantized by the
port's ``quantize_model`` and by the JAX package's from the same float32
weights, in three forms: ``int4`` (every linear becomes ``int4p``, kernel
C), ``int4`` with ``layout="row"`` (kernel B with the ramp LUT) and
``w4a8`` (kernels D-fused and D).

Bars: the quantized weights equal JAX's field for field; logits within
2e-2 * max|ref| (the repo's kernel bar); greedy tokens equal over 8 new
tokens; checkpoints written by either package load in the other and give
the same logits.
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
from test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from test_torch_convert import assert_close_max, jax_to_numpy

WIDTHS = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2)
MODELS = {"int4": ("int4", {}), "int4_row": ("int4", {"layout": "row"}),
          "w4a8": ("w4a8", {})}
KIND = {"int4": "int4p", "int4_row": "int4", "w4a8": "w4a8"}
LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
           "down_proj")


def _ids(b=2, t=12, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    fmt, kw = MODELS[request.param]
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), **WIDTHS,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(), **WIDTHS,
                               dtype=torch.float32)
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    jq = japi.quantize_model(dense, fmt=fmt, group_size=128, **kw)
    tq = api.quantize_model(
        convert.from_jax_params(jax_to_numpy(dense), device="cpu"), fmt=fmt,
        group_size=128, device="cpu", **kw)
    return request.param, jcfg, tcfg, jq, tq


def test_weights_equal_jax(pair):
    name, _, _, jq, tq = pair
    for jl, tl in zip(jq["layers"], tq["layers"]):
        for key in LINEARS:
            ref = convert.qt_from_jax(jax_to_numpy(jl[key]), device="cpu")
            got = tl[key]
            assert got.fmt == ref.fmt == KIND[name] and got.lut is None
            for f in ("packed", "scales", "zeros"):
                assert torch.equal(getattr(got, f), getattr(ref, f)), (key, f)


def test_logits_match_jax(pair, monkeypatch):
    name, jcfg, tcfg, jq, tq = pair
    ids = _ids(t=12, seed=3)
    ref = np.asarray(jllama.forward(jq, jcfg, jnp.asarray(ids),
                                    interpret=True)[0])
    calls = []
    for plain in ("q4_int4_magic_plain", "q4_lut_fused_plain",
                  "w4a8_fused_plain", "w4a8_plain"):
        orig = getattr(gemv, plain)
        monkeypatch.setattr(gemv, plain, lambda *a, _o=orig, _n=plain:
                            calls.append(_n) or _o(*a))
    got = llama.forward(tq, tcfg, torch.from_numpy(ids))[0]
    want = {"int4": "q4_int4_magic_plain", "int4_row": "q4_lut_fused_plain",
            "w4a8": "w4a8_fused_plain"}[name]
    assert set(calls) == {want} and len(calls) == 7 * 2
    assert_close_max(got, ref, 2e-2)


def test_greedy_tokens_match_jax(pair):
    _, jcfg, tcfg, jq, tq = pair
    ids = _ids(b=2, t=6, seed=4)
    ref = np.asarray(jgen.generate(jq, jcfg, jnp.asarray(ids),
                                   max_new_tokens=8))
    out = generate.generate(tq, tcfg, torch.from_numpy(ids),
                            max_new_tokens=8, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_checkpoints_both_ways(pair, tmp_path):
    name, jcfg, tcfg, jq, tq = pair
    ids = torch.from_numpy(_ids(t=7, seed=7))
    want = llama.forward(tq, tcfg, ids)[0].numpy()
    jckpt.save_params(str(tmp_path / "jax"), jq, jcfg)
    params, cfg = checkpoint.load_params(str(tmp_path / "jax"), device="cpu")
    assert cfg == tcfg
    assert isinstance(params["layers"][1]["up_proj"], tlin.QuantizedTensor)
    np.testing.assert_array_equal(llama.forward(params, cfg, ids)[0].numpy(),
                                  want)
    checkpoint.save_params(str(tmp_path / "port"), tq, tcfg)
    jparams, jcfg2 = jckpt.load_params(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    assert jparams["layers"][0]["q_proj"].fmt == KIND[name]
    assert jparams["layers"][0]["q_proj"].lut is None
    x = jnp.asarray(ids.numpy())
    np.testing.assert_array_equal(
        np.asarray(jllama.forward(jparams, jcfg2, x, interpret=True)[0]),
        np.asarray(jllama.forward(jq, jcfg, x, interpret=True)[0]))
