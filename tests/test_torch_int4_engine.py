"""The port's serving engine against the JAX package's with int4 and W4A8
weights, on the CPU: a 2-layer float32 Llama with widths that are multiples
of 128, quantized by the JAX package at g=128 and carried across. Both
engines get the same prompts; int4 must give the same tokens up to the
first near-tie, with teacher-forced logits within ``QUANT_TIE`` of JAX's
(``test_torch_engine._both``), W4A8 the same tokens, token for token, in
the paged and the contiguous layout, with bursts and with the pipeline.
One prompt of 70 tokens makes a 128-row prefill, so W4A8 runs both
kernel D (prefill above 64 rows) and kernel D-fused (decode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from any4_tpu.models import llama as jllama
from any4_tpu.quant import api as japi
from test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from test_torch_engine import QUANT_TIE, _both, _pair, _prompts

WIDTHS = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2)
# int4/int8 round activations to bf16 (tie rule); W4A8/W8A8 stay
# token-exact
TIES = {"int4p": QUANT_TIE, "w4a8": 0.0}
RUNS = {"paged_burst4": dict(kv_layout="paged", run=dict(burst=4)),
        "contig_burst2_pipeline": dict(kv_layout="contig",
                                       run=dict(burst=2, pipeline=True))}


@pytest.fixture(scope="module", params=["int4", "w4a8"])
def model(request):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab=256),
                               **WIDTHS, dtype=jnp.float32)
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    return _pair(japi.quantize_model(dense, fmt=request.param,
                                     group_size=128), jcfg)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_matches_jax(model, run):
    assert model[2]["layers"][0]["q_proj"].fmt in ("int4p", "w4a8")
    tie = TIES[model[2]["layers"][0]["q_proj"].fmt]
    got, e = _both(model, _prompts(11, (70, 5, 9)), 5, max_slots=2,
                   max_ctx=256, page_size=8, tie=tie, **RUNS[run])
    assert [len(t) for t in got] == [5, 5, 5]
    assert not e.seq_lens.any() and not e.tokens.any()
