"""The port's datasets, harness and perplexity (``any4_tpu_torch/evals``)
against the JAX package's, on the CPU.

Models: ``LlamaConfig.tiny`` (vocab 256, 2 layers) in float32, made by the
JAX package from a seed and carried across as numpy. Bars:
- ``synthetic_tokens``, ``seeded_crops``, the c4 document crops and
  ``synthetic_loaders``: equal to JAX's, bit for bit;
- perplexity, chunked and stream: log-perplexity within 1e-4 relative of
  JAX's on the dense model (the same ops; float32 sums in another order);
  the any4 model (g=64, JAX's ``quantize_model``), the port through its
  quantized forward and JAX through ``dequantize_model``: within
  ``ANY4_PPL_TOL`` relative, since the port's kernels round x and the table
  to bf16 where the dequantized float32 forward does not;
- ``results.json``, ``args.json`` and ``command_line.txt``: the JAX
  harness's keys, and ``cli_process_logs.py`` reads a directory the port
  wrote.
"""
import dataclasses
import json
import math
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cli_process_logs
from any4_tpu.evals import datasets as jdatasets
from any4_tpu.evals import harness as jharness
from any4_tpu.evals import perplexity as jperplexity
from any4_tpu.models import llama as jllama
from any4_tpu.quant import api as japi
from any4_tpu_torch import convert
from any4_tpu_torch.evals import datasets, harness, perplexity
from any4_tpu_torch.models import llama
from test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from test_torch_convert import jax_to_numpy

PPL_TOL = 1e-4
# the any4 model: the port's kernels (plain versions here) round x and the
# LUT to bf16, JAX's dequantized float32 forward does not (the gap measured
# 1.4e-4 on the chunked case)
ANY4_PPL_TOL = 1e-3


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params): the same float32
    tiny model."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab=256, layers=2),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab=256, layers=2),
                               dtype=torch.float32)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, convert.from_jax_params(jax_to_numpy(jp),
                                                   device="cpu")


@pytest.fixture(scope="module")
def any4_models(models):
    """(port any4 params, JAX's dequantized any4 params): JAX quantizes
    (g=64), the port reads its tree."""
    _, jp, _, _ = models
    jq = japi.quantize_model(jp, fmt="any4", group_size=64, kmeans_iters=4)
    return (convert.from_jax_params(jax_to_numpy(jq), device="cpu"),
            japi.dequantize_model(jq))


@pytest.fixture
def no_hf_datasets(monkeypatch):
    """Make ``import datasets`` (Hugging Face's) fail, as where it is not
    installed: the loaders raise without reaching for the network."""
    monkeypatch.setitem(sys.modules, "datasets", None)


def _rel(a, b):
    return abs(a - b) / abs(b)


# ------------------------------------------------------------- datasets
@pytest.mark.parametrize("vocab,n,seed", [(256, 2000, 0), (512, 4096, 3),
                                          (128256, 16384, 0), (7, 50, 11)])
def test_synthetic_tokens_bit_equal(vocab, n, seed):
    got = datasets.synthetic_tokens(vocab, n, seed=seed)
    ref = jdatasets.synthetic_tokens(vocab, n, seed=seed)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("length,nsamples,seqlen,seed", [
    (5000, 16, 128, 7), (4000, 8, 64, 0), (100, 3, 100, 1), (50, 2, 64, 2)])
def test_seeded_crops_bit_equal(length, nsamples, seqlen, seed):
    ids = datasets.synthetic_tokens(1000, length, seed=3)
    got = datasets.seeded_crops(ids, nsamples, seqlen, seed)
    # the stdlib rng's state must not matter, only the seed
    random.seed(123)
    ref = jdatasets.seeded_crops(ids, nsamples, seqlen, seed)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (nsamples, seqlen)


def test_doc_crops_bit_equal():
    class Tok:
        def encode(self, text):
            return [ord(c) % 97 for c in text]

    rng = np.random.default_rng(0)
    docs = ["".join(chr(97 + c) for c in rng.integers(0, 26, n))
            for n in (3, 300, 40, 150, 90, 512, 7)]
    got = datasets._seeded_doc_crops(docs, Tok(), 6, 64, seed=5)
    ref = jdatasets._seeded_doc_crops(docs, Tok(), 6, 64, seed=5)
    np.testing.assert_array_equal(got, ref)


def test_synthetic_loaders_equal():
    got = datasets.synthetic_loaders(256, nsamples=4, seqlen=32, seed=2)
    ref = jdatasets.synthetic_loaders(256, nsamples=4, seqlen=32, seed=2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_dataset_configs_and_offline_errors(no_hf_datasets):
    assert datasets.task_dataset_configs.keys() == \
        jdatasets.task_dataset_configs.keys()
    for k, cfg in datasets.task_dataset_configs.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jdatasets.task_dataset_configs[k])
    with pytest.raises(ValueError):
        datasets.load_text("not-a-task")
    with pytest.raises(ValueError):
        datasets.get_loaders("nope", tokenizer=None)
    with pytest.raises(datasets.DatasetUnavailable):
        datasets.load_text("wikitext-2", max_chars=100)
    with pytest.raises(datasets.DatasetUnavailable):
        datasets.get_loaders("wikitext-2", tokenizer=None, nsamples=1,
                             seqlen=32)


# ----------------------------------------------------------- perplexity
def test_token_logprobs_against_log_softmax():
    """Blocks of ``rows`` positions give log_softmax's values, over a
    prefix of the positions."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 9, 40), generator=g).to(torch.bfloat16)
    tgt = torch.randint(0, 40, (2, 7), generator=g)
    lp, hit = perplexity.token_logprobs(logits, tgt, rows=3)
    ref = torch.log_softmax(logits[:, :7].float(), -1)
    torch.testing.assert_close(
        lp, ref.gather(2, tgt[..., None])[..., 0], rtol=0, atol=1e-6)
    assert torch.equal(hit, ref.argmax(-1) == tgt)


@pytest.mark.parametrize("batch_size,max_chunks", [(1, 3), (2, 3), (4, None)])
def test_chunked_matches_jax(models, batch_size, max_chunks):
    jcfg, jp, tcfg, tp = models
    tokens = datasets.synthetic_tokens(256, 500, seed=1)
    got = perplexity.eval_perplexity_chunked(
        tp, tcfg, tokens, seqlen=64, batch_size=batch_size,
        max_chunks=max_chunks, device="cpu")
    ref = jperplexity.eval_perplexity_chunked(
        jp, jcfg, tokens, seqlen=64, batch_size=batch_size,
        max_chunks=max_chunks)
    assert _rel(math.log(got), math.log(ref)) <= PPL_TOL


def test_stream_matches_jax(models):
    """Documents shorter than a window, of one token (skipped), of exactly
    ``seqlen + 1`` and longer."""
    jcfg, jp, tcfg, tp = models
    tokens = datasets.synthetic_tokens(256, 600, seed=2)
    docs = [tokens[:1], tokens[1:30], tokens[30:95], tokens[95:400],
            tokens[400:]]
    got = perplexity.eval_perplexity_stream(tp, tcfg, docs, seqlen=64,
                                            device="cpu")
    ref = jperplexity.eval_perplexity_stream(jp, jcfg, docs, seqlen=64)
    assert _rel(math.log(got), math.log(ref)) <= PPL_TOL
    got2 = perplexity.eval_perplexity_stream(tp, tcfg, docs, seqlen=64,
                                             max_samples=3, device="cpu")
    ref2 = jperplexity.eval_perplexity_stream(jp, jcfg, docs, seqlen=64,
                                              max_samples=3)
    assert _rel(math.log(got2), math.log(ref2)) <= PPL_TOL


@pytest.mark.parametrize("evaluator", ["chunked", "stream"])
def test_any4_perplexity_matches_jax_dequantized(models, any4_models,
                                                 evaluator):
    jcfg, _, tcfg, _ = models
    tq, jdense = any4_models
    tokens = datasets.synthetic_tokens(256, 400, seed=4)
    if evaluator == "chunked":
        got = perplexity.eval_perplexity_chunked(tq, tcfg, tokens, seqlen=64,
                                                 max_chunks=3, device="cpu")
        ref = jperplexity.eval_perplexity_chunked(jdense, jcfg, tokens,
                                                  seqlen=64, max_chunks=3)
    else:
        docs = [tokens[:150], tokens[150:]]
        got = perplexity.eval_perplexity_stream(tq, tcfg, docs, seqlen=64,
                                                device="cpu")
        ref = jperplexity.eval_perplexity_stream(jdense, jcfg, docs,
                                                 seqlen=64)
    assert _rel(math.log(got), math.log(ref)) <= ANY4_PPL_TOL


def test_perplexity_errors(models):
    _, _, tcfg, tp = models
    tokens = datasets.synthetic_tokens(256, 100, seed=1)
    with pytest.raises(ValueError, match="shorter than one chunk"):
        perplexity.eval_perplexity_chunked(tp, tcfg, tokens[:10], seqlen=64,
                                           device="cpu")
    with pytest.raises(ValueError, match="two tokens"):
        perplexity.eval_perplexity_stream(tp, tcfg, [tokens[:1]],
                                          device="cpu")
    # entry points run on the GPU unless asked; these params are on the CPU
    with pytest.raises(ValueError, match="params are on cpu"):
        perplexity.eval_perplexity_chunked(tp, tcfg, tokens, seqlen=64)


# -------------------------------------------------------------- harness
def _entries(d):
    with open(os.path.join(d, "results.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("evaluator", ["chunked", "stream"])
def test_run_perplexity_tasks_matches_jax(models, tmp_path, evaluator):
    jcfg, jp, tcfg, tp = models
    kw = dict(seqlen=128, max_chunks=2, synthetic=True, evaluator=evaluator)
    got = harness.run_perplexity_tasks(
        tp, tcfg, ["wikitext-2"], log_dir=str(tmp_path / "port"),
        device="cpu", **kw)
    ref = jharness.run_perplexity_tasks(
        jp, jcfg, ["wikitext-2"], log_dir=str(tmp_path / "jax"), **kw)
    assert got.keys() == ref.keys() == {"synthetic:wikitext-2"}
    for k in got:
        assert _rel(math.log(got[k]), math.log(ref[k])) <= PPL_TOL
    port, jx = _entries(tmp_path / "port"), _entries(tmp_path / "jax")
    assert port.keys() == jx.keys()
    for k in port:
        assert port[k].keys() == jx[k].keys() == {"result", "time", "seqlen"}
        assert port[k]["seqlen"] == jx[k]["seqlen"] == 128
    # the skip of a task already in results.json
    again = harness.run_perplexity_tasks(
        tp, tcfg, ["wikitext-2"], log_dir=str(tmp_path / "port"),
        device="cpu", **kw)
    assert again == {}


def test_log_files_match_jax(tmp_path):
    args = {"tasks": "synthetic", "seqlen": 128, "quantize": None}
    for pkg, d in ((harness, tmp_path / "port"), (jharness, tmp_path / "jx")):
        pkg.log_args(str(d), args)
        pkg.log_results(str(d), "a", 1.5)
        pkg.log_results(str(d), "b", {"acc": 0.5, "n": 6}, {"seqlen": 64})
        pkg.log_results(str(d), "a", 1.0)
        assert pkg.task_done(str(d), "a") and not pkg.task_done(str(d), "c")
    for name in ("args.json", "command_line.txt"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jx" / name).read_text()
    port, jx = _entries(tmp_path / "port"), _entries(tmp_path / "jx")
    assert {k: {f: v for f, v in e.items() if f != "time"}
            for k, e in port.items()} == \
        {k: {f: v for f, v in e.items() if f != "time"}
         for k, e in jx.items()} == {
            "a": {"result": 1.0}, "b": {"result": {"acc": 0.5, "n": 6},
                                        "seqlen": 64}}


def test_process_logs_reads_port_logs(models, tmp_path):
    _, _, tcfg, tp = models
    d = tmp_path / "logs" / "run"
    out = harness.run_perplexity_tasks(
        tp, tcfg, ["wikitext-2"], seqlen=64, max_chunks=1, synthetic=True,
        log_dir=str(d), device="cpu")
    harness.log_results(str(d), "lm-eval:local_mc", {"acc": 0.5, "n": 6})
    csv_path = tmp_path / "all.csv"
    cli_process_logs.main([str(tmp_path / "logs"), "--output",
                           str(csv_path)])
    rows = csv_path.read_text().strip().splitlines()
    assert rows[0] == "log_dir,task,metric,result"
    got = {tuple(r.split(",")[1:3]): r.split(",")[3] for r in rows[1:]}
    assert got.keys() == {("synthetic:wikitext-2", ""),
                          ("lm-eval:local_mc", "acc"),
                          ("lm-eval:local_mc", "n")}
    assert float(got[("synthetic:wikitext-2", "")]) == \
        out["synthetic:wikitext-2"]
