"""The port's scripts (``any4_tpu_torch/cli/``) on the CPU, at tiny sizes,
against the JAX package's scripts and file formats.

- every script runs with ``--cpu`` and prints JAX's JSON field names; each
  raises without ``--cpu`` where there is no GPU;
- the tokens that ``decode_tokens_per_s`` times are ``generate``'s;
- ``quantize --tiny --fmt any4`` writes a checkpoint that JAX's
  ``load_params`` reads, and JAX's forward on it (through JAX's
  dequantization) is within 2e-2 * max of the port's on the same
  quantized fields;
- ``--dump-awq`` then ``--load-awq`` give the same checkpoint bits, also
  through JAX's ``save_awq``, and JAX's ``load_awq`` reads the port's dump;
- ``calibrate --tiny`` writes the ``.npz`` JAX's ``load_calibration`` reads,
  under the names JAX's ``quantize_model`` looks sample weights up by;
- ``parse_kv_args`` is ``cli_eval.parse_kv_args``;
- ``eval --tiny`` gives ``cli_eval.py``'s result names and log files, which
  ``cli_process_logs.py`` reads; a checkpoint it saves loads back with the
  same perplexity; ``analyze --tiny`` writes the JAX analyzer's CSV
  columns and plots, ``diff --tiny`` one row a linear and the logits;
- ``calibrate --dataset`` loads its tokens through ``evals.datasets``,
  which raises ``DatasetUnavailable`` where Hugging Face's ``datasets``
  cannot load the task.
"""
import contextlib
import csv
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cli_eval
import cli_process_logs
from any4_tpu import calibrate as jcal
from any4_tpu.models import checkpoint as jcheckpoint
from any4_tpu.models import llama as jllama
from any4_tpu.quant import api as japi
from any4_tpu.quant import awq as jawq
from any4_tpu_torch.cli import analyze as analyze_cli
from any4_tpu_torch.cli import diff as diff_cli
from any4_tpu_torch.cli import eval as eval_cli
from any4_tpu_torch.cli import (benchmark, calibrate, common, example,
                                microbenchmark, quantize)
from any4_tpu_torch.evals import datasets
from any4_tpu_torch.models import checkpoint, generate, llama
from any4_tpu_torch.ops import linear as tlin
from any4_tpu_torch.quant import api, awq
from test_torch_convert import assert_close_max

# the JSON fields of the JAX package's scripts (cli_microbenchmark.py:71-79,
# cli_benchmark.py:81-92)
MICRO_FIELDS = {"fmt", "m", "k", "n", "bf16_us", "quant_us", "speedup",
                "weight_bytes", "weight_gbps"}
SWEEP_FIELDS = {"int4", "nf4", "any4", "bf16_us"}
PROFILE_LAYER_FIELDS = {"attention_ms", "mlp_ms"}
PROFILE_TOTAL_FIELDS = {"attention_ms", "mlp_ms", "attention_share",
                        "sum_ms", "layers_profiled"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch for this file's tests: in the parallel test
    run the workers already fill the cores, and torch's intra-op threads
    then spin against them on these tiny shapes (one CPU benchmark run
    went from 2 s to 120 s on a loaded machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(main, argv):
    """``main(argv)``'s return value and its last stdout line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    return ret, out.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("s", ["", "a=1", "a=1,b=2.5,c=true,d=False,e=x",
                               "group_size=128,scale_sample_weight=True",
                               " k = v ", "a=", "a=1e-3,b=-4,c=TRUE"])
def test_parse_kv_args_matches_cli_eval(s):
    assert common.parse_kv_args(s) == cli_eval.parse_kv_args(s)


@pytest.mark.parametrize("fmt", microbenchmark.FORMATS)
def test_microbenchmark_fields(fmt):
    calls = []
    out, line = _run(
        lambda argv: microbenchmark.main(
            argv, check=lambda x, qt: calls.append((x, qt))),
        ["--cpu", "--input-dim", "256", "--output-dim", "128", "--quantize",
         fmt, "--rounds", "1", "--iters", "1"])
    assert json.loads(line) == out
    # the check hook sees the row's operands once, before they are timed
    (x, qt), = calls
    assert x.shape == (1, 256) and x.dtype == torch.bfloat16
    assert qt.shape == (128, 256) and qt.fmt == out["weight_fmt"]
    assert MICRO_FIELDS <= set(out)
    assert (out["fmt"], out["m"], out["k"], out["n"]) == (fmt, 1, 256, 128)
    assert out["kernels"] == {} and out["device"] == "cpu"
    assert out["bf16_us"] > 0 and out["quant_us"] > 0


def test_microbenchmark_sweep_fields():
    calls = []
    table = microbenchmark.sweep(ks=(256,), rounds=1, iters=1, device="cpu",
                                 check=lambda *a: calls.append(a))
    assert set(table) == {256}
    assert SWEEP_FIELDS <= set(table[256])
    k, x, wb, qts = calls[0]
    assert k == 256 and x.shape == (1, 256) and wb.shape == (256, 256)
    assert {f: q.fmt for f, q in qts.items()} == {
        "int4": "int4p", "nf4": "nf4t", "any4": "any4t"}
    for qt in qts.values():
        y = microbenchmark.sweep_call(x, qt)
        ref = x.float() @ tlin.dequantize_tensor(qt, torch.float32).T
        assert_close_max(y, ref, 1e-2)


def test_benchmark_fields():
    out, line = _run(benchmark.main, [
        "--cpu", "--tiny", "--profile", "--prompt-tokens", "8",
        "--max-new-tokens", "4", "--profile-ctx", "32"])
    assert json.loads(line) == out
    assert set(out) == {"baseline_tok_s", "any4_tok_s", "speedup",
                        "model_bytes_baseline", "model_bytes_quantized",
                        "profile_baseline", "profile_quantized", "device"}
    for key in ("profile_baseline", "profile_quantized"):
        prof = out[key]
        assert set(prof) == {"layers.0", "layers.1", "totals"}
        assert set(prof["layers.0"]) == PROFILE_LAYER_FIELDS
        assert set(prof["totals"]) == PROFILE_TOTAL_FIELDS


def test_decode_tokens_per_s_times_generate_tokens():
    cfg = llama.LlamaConfig.tiny(vocab=512, layers=2)
    params = llama.init_params(cfg, seed=3, device="cpu")
    qparams = api.quantize_model(params, fmt="any4", group_size=64,
                                 kmeans_iters=2, device="cpu")
    prompt = common.random_ids((2, 6), cfg.vocab_size, "cpu")
    for p in (params, qparams):
        tps, tokens = benchmark.decode_tokens_per_s(p, cfg, prompt, 5,
                                                    trials=1)
        ref = generate.generate(p, cfg, prompt, max_new_tokens=5,
                                device="cpu")
        assert tps > 0 and tokens.shape == (2, 6)
        assert torch.equal(tokens[:, :5], ref[:, 6:])


def _arrays(path):
    with np.load(f"{path}/params.npz") as raw:
        return {k: raw[k] for k in raw.files}


@pytest.fixture(scope="module")
def awq_runs(tmp_path_factory):
    """``quantize --awq --dump-awq`` and ``--load-awq`` of its dump, at
    g=64 (the tiny model's k is 64)."""
    d = tmp_path_factory.mktemp("awq")
    base = ["--cpu", "--tiny", "--calibrate", "--group-size", "64",
            "--kmeans-iters", "4"]
    _run(quantize.main, base + ["--awq", "--dump-awq", str(d / "a.npz"),
                                "--output", str(d / "dumped")])
    _run(quantize.main, base + ["--load-awq", str(d / "a.npz"),
                                "--output", str(d / "loaded")])
    return d, base


def test_dump_and_load_awq_give_the_same_checkpoint(awq_runs):
    d, _ = awq_runs
    dumped, loaded = _arrays(d / "dumped"), _arrays(d / "loaded")
    assert sorted(dumped) == sorted(loaded)
    for k, v in dumped.items():
        np.testing.assert_array_equal(v, loaded[k], err_msg=k)


def test_awq_dumps_cross_with_jax(awq_runs):
    d, base = awq_runs
    port = awq.load_awq(str(d / "a.npz"))
    ref = jawq.load_awq(str(d / "a.npz"))
    assert port["clip"] == ref["clip"] and port["clip"]
    assert sorted(port["scales"]) == sorted(ref["scales"])
    for key, entry in port["scales"].items():
        assert entry["ratio"] == ref["scales"][key]["ratio"]
        assert entry["targets"] == ref["scales"][key]["targets"]
        for field in ("scales", "scales_prev"):
            np.testing.assert_array_equal(entry[field],
                                          ref["scales"][key][field])
    jawq.save_awq(str(d / "jax.npz"), ref)
    _run(quantize.main, base + ["--load-awq", str(d / "jax.npz"),
                                "--output", str(d / "from_jax")])
    dumped, from_jax = _arrays(d / "dumped"), _arrays(d / "from_jax")
    for k, v in dumped.items():
        np.testing.assert_array_equal(v, from_jax[k], err_msg=k)


def test_quantize_checkpoint_loads_in_jax(tmp_path):
    (qparams, cfg), _ = _run(quantize.main, [
        "--cpu", "--tiny", "--fmt", "any4", "--kmeans-iters", "4",
        "--output", str(tmp_path)])
    jp, jcfg = jcheckpoint.load_params(str(tmp_path))
    tp, tcfg = checkpoint.load_params(str(tmp_path), device="cpu")
    assert jcfg.vocab_size == tcfg.vocab_size == cfg.vocab_size
    fmts = {jp["layers"][0][k].fmt for k in ("q_proj", "down_proj")}
    assert fmts == {"any4", "any4t"}
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 12))
    # JAX's forward, jitted, through its own dequantization
    # (fused_m_max=0): its interpreted Pallas kernels take seconds a shape
    # on the CPU
    ref = jax.jit(lambda p, i: jllama.forward(p, jcfg, i, fused_m_max=0)[0])(
        jp, jnp.asarray(ids, jnp.int32))
    got, _ = llama.forward(tp, tcfg, torch.from_numpy(ids))
    mine, _ = llama.forward(qparams, cfg, torch.from_numpy(ids))
    assert torch.equal(got, mine)
    assert_close_max(got, np.asarray(ref, np.float32), 2e-2)


def test_calibrate_npz_reads_in_jax(tmp_path):
    path = str(tmp_path / "acts.npz")
    acts, _ = _run(calibrate.main, ["--cpu", "--tiny", "--output", path])
    loaded = jcal.load_calibration(path)
    # the names JAX's quantize_model looks sample weights up by, each [k]
    jcfg = jllama.LlamaConfig.tiny(vocab=2048, layers=2)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    ref = {name: (leaf.shape[1],) for name, leaf, _ in japi._walk(jp)
           if japi.default_layer_filter(name, leaf)
           and name.split(".")[-1] not in japi.DEFAULT_SKIP}
    assert sorted(loaded) == sorted(ref) == sorted(acts)
    for name, shape in ref.items():
        assert loaded[name].shape == shape
        np.testing.assert_array_equal(loaded[name], acts[name].numpy())


def test_example_runs():
    (before, after), _ = _run(example.main, ["--cpu", "--prompt-tokens", "4"])
    assert before.shape == after.shape == (1, 12)
    assert torch.equal(before[:, :4], after[:, :4])


_SCRIPTS = {
    "microbenchmark": (microbenchmark.main, ["--input-dim", "256"]),
    "sweep": (microbenchmark.main, ["--sweep"]),
    "benchmark": (benchmark.main, ["--tiny"]),
    "quantize": (quantize.main, ["--tiny", "--output", "unused"]),
    "calibrate": (calibrate.main, ["--tiny", "--output", "unused.npz"]),
    "example": (example.main, []),
    "eval": (eval_cli.main, ["--tiny", "--log-dir", "unused"]),
    "analyze": (analyze_cli.main, ["--tiny", "--log-dir", "unused"]),
    "diff": (diff_cli.main, ["--tiny", "--log-dir", "unused"]),
}


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_scripts_need_a_gpu_without_cpu_flag(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device works")
    main, argv = _SCRIPTS[name]
    with pytest.raises(RuntimeError, match="no CUDA device; pass --cpu"):
        main(argv)


def test_unported_options_raise(tmp_path, monkeypatch):
    # --row-parallel-shards (item 12) is ported: the row-parallel weights
    # are packed in 2 k segments, and the checkpoint keeps them so
    qparams, _ = _run(quantize.main, ["--cpu", "--tiny", "--fmt", "int4",
                                      "--row-parallel-shards", "2",
                                      "--output", str(tmp_path / "q")])[0]
    assert qparams["layers"][0]["down_proj"].row_shards == 2
    assert qparams["layers"][0]["q_proj"].row_shards == 1
    back, _ = checkpoint.load_params(str(tmp_path / "q"), device="cpu")
    assert back["layers"][1]["o_proj"].row_shards == 2
    # --dataset goes through evals.datasets: where Hugging Face's datasets
    # cannot load the task it raises DatasetUnavailable (the import is made
    # to fail here, so that nothing reaches for the network)
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(datasets.DatasetUnavailable, match="wikitext-2"):
        calibrate.main(["--cpu", "--tiny", "--dataset", "wikitext-2",
                        "--output", str(tmp_path / "a.npz")])


# cli_eval.py's result names for these tasks
EVAL_RESULTS = {"synthetic:wikitext-2", "lm-eval:local_mc", "code:builtin"}


def test_eval_script_logs(tmp_path):
    d = tmp_path / "logs" / "t"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = eval_cli.main([
            "--cpu", "--tiny", "--quantize", "int4", "--tasks", "synthetic",
            "--seqlen", "64", "--max-chunks", "2", "--lm-eval-tasks",
            "local_mc", "--code-tasks", "builtin", "--log-dir", str(d)])
    assert set(results) == EVAL_RESULTS
    printed = out.getvalue()
    assert json.loads(printed[printed.index("{\n"):]) == results
    assert 1 < results["synthetic:wikitext-2"] < 2048 * 10
    assert results["lm-eval:local_mc"]["n"] == 6
    assert results["code:builtin"]["n_problems"] == 4
    with open(d / "results.json") as f:
        logged = json.load(f)
    assert set(logged) == EVAL_RESULTS
    assert logged["synthetic:wikitext-2"]["seqlen"] == 64
    with open(d / "args.json") as f:
        args = json.load(f)
    assert args["quantize"] == "int4" and args["cpu"] is True
    assert (d / "command_line.txt").read_text().startswith("python ")
    assert (d / "code_builtin.json").exists()
    cli_process_logs.main([str(tmp_path / "logs"), "--output",
                           str(tmp_path / "all.csv")])
    with open(tmp_path / "all.csv") as f:
        rows = list(csv.DictReader(f))
    assert {r["task"] for r in rows} == EVAL_RESULTS


def test_eval_script_checkpoint_round_trip(tmp_path):
    """``--calibrate --save-quantized``, then ``--load-quantized``: the same
    perplexity."""
    base = ["--cpu", "--tiny", "--tasks", "synthetic", "--seqlen", "32",
            "--max-chunks", "2"]
    q = str(tmp_path / "q")
    saved, _ = _run(eval_cli.main, base + [
        "--quantize", "any4", "--quantize-args", "kmeans_iters=2",
        "--calibrate", "--save-quantized", q,
        "--log-dir", str(tmp_path / "a")])
    loaded, _ = _run(eval_cli.main, base + [
        "--load-quantized", q, "--log-dir", str(tmp_path / "b")])
    assert saved == loaded and set(saved) == {"synthetic:wikitext-2"}
    assert jcheckpoint.load_params(q)[1].vocab_size == 2048


def test_analyze_script(tmp_path):
    acts, _ = _run(calibrate.main, [
        "--cpu", "--tiny", "--output", str(tmp_path / "acts.npz")])
    rows, _ = _run(analyze_cli.main, [
        "--cpu", "--tiny", "--formats", "int4,nf4", "--group-size", "32",
        "--calibration", str(tmp_path / "acts.npz"),
        "--log-dir", str(tmp_path / "an")])
    with open(tmp_path / "an" / "stats.csv") as f:
        header = next(csv.reader(f))
    # cli_analyze.py's columns for these formats
    assert header == ["layer", "shape", "mean", "std", "min", "max",
                      "entropy"] + [f"{f}_{m}" for f in ("int4", "nf4")
                                    for m in ("w_mse", "y_mse", "y_cossim")]
    assert len(rows) == 15 and rows[-1]["layer"] == "lm_head"
    pdf = (tmp_path / "an" / "plots.pdf").read_bytes()
    assert pdf.startswith(b"%PDF") and len(pdf) > 10000
    _run(analyze_cli.main, ["--cpu", "--tiny", "--formats", "int4",
                            "--no-plots", "--log-dir", str(tmp_path / "np")])
    assert not (tmp_path / "np" / "plots.pdf").exists()


def test_diff_script(tmp_path):
    rows, line = _run(diff_cli.main, [
        "--cpu", "--tiny", "--quantize", "int4", "--group-size", "32",
        "--prompt-tokens", "16", "--log-dir", str(tmp_path)])
    assert len(rows) == 2 * 7 + 1 and line.startswith("logits: mse ")
    assert all(0.5 < r["cossim"] <= 1 + 1e-6 for r in rows)
    with open(tmp_path / "diffs.csv") as f:
        assert next(csv.reader(f)) == ["layer", "mse", "cossim"]
