"""The port's serving engine against the JAX package's with int8 and W8A8
weights, on the CPU: a 2-layer float32 Llama with widths that are multiples
of 128, quantized by the JAX package at g=128 (every linear ``int8q`` or
``w8a8q``) or as int8 at g=64 (every linear ``int8``, the row layout of
``int8_fused``) and carried across. Both engines get the same prompts; int8
must give the same tokens up to the first near-tie, with teacher-forced
logits within ``QUANT_TIE`` of JAX's (``test_torch_engine._both``), W8A8
the same tokens, token for token, in the paged and the contiguous layout,
with bursts and with the pipeline. One prompt of 70 tokens makes a
128-row prefill, so W8A8 runs both ``w8a8`` (prefill above 64 rows) and
``w8a8_fused`` (decode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from any4_tpu.models import llama as jllama
from any4_tpu.quant import api as japi
from test_torch_engine import QUANT_TIE, _both, _pair, _prompts

WIDTHS = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2)
# int4/int8 round activations to bf16 (tie rule); W4A8/W8A8 stay
# token-exact
TIES = {"int8q": QUANT_TIE, "int8": QUANT_TIE, "w8a8q": 0.0}
RUNS = {"paged_burst4": dict(kv_layout="paged", run=dict(burst=4)),
        "contig_burst2_pipeline": dict(kv_layout="contig",
                                       run=dict(burst=2, pipeline=True))}


@pytest.fixture(scope="module", params=["int8", "w8a8", "int8_g64"])
def model(request):
    fmt, g = ("int8", 64) if request.param == "int8_g64" \
        else (request.param, 128)
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab=256),
                               **WIDTHS, dtype=jnp.float32)
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    return _pair(japi.quantize_model(dense, fmt=fmt, group_size=g), jcfg)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_matches_jax(model, run):
    assert model[2]["layers"][0]["q_proj"].fmt in ("int8q", "int8", "w8a8q")
    tie = TIES[model[2]["layers"][0]["q_proj"].fmt]
    got, e = _both(model, _prompts(12, (70, 5, 9)), 5, max_slots=2,
                   max_ctx=256, page_size=8, tie=tie, **RUNS[run])
    assert [len(t) for t in got] == [5, 5, 5]
    assert not e.seq_lens.any() and not e.tokens.any()
