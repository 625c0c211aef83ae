"""The port's LM protocol (``TorchCausalLM``), local tasks and code eval
against the JAX package's ``JaxCausalLM`` on the CPU.

One float32 ``LlamaConfig.tiny`` (vocab 256, 2 layers) made by the JAX
package from a seed, carried across as numpy; ``ByteTokenizer``; one
``JaxCausalLM`` for the file, ``max_length=128``. Bars:
- ``loglikelihood`` and ``loglikelihood_rolling``: within 1e-4 relative of
  JAX's (the same ops; float32 sums in another order), greedy flags equal;
  batched within 1e-5 relative of one request at a time;
- ``generate_until``: the same text as JAX's, and the tokens of the port's
  greedy ``generate``; the stop sequence, the empty continuation and
  ``max_gen_toks > max_length`` as in JAX;
- ``code_eval``: the executor, its timeout, ``pass_at_k`` and an oracle;
  the model route gives JAX's completions.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.evals import code_eval as jcode_eval
from any4_tpu.evals import tasks_local as jtasks_local
from any4_tpu.evals.lm_eval_adapter import JaxCausalLM
from any4_tpu.models import llama as jllama
from any4_tpu_torch import convert
from any4_tpu_torch.evals import code_eval, lm_eval_adapter, tasks_local
from any4_tpu_torch.evals.lm_eval_adapter import TorchCausalLM
from any4_tpu_torch.models import generate, llama
from test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from test_torch_convert import jax_to_numpy

LL_TOL = 1e-4
BATCH_TOL = 1e-5
MAX_LENGTH = 128

REQUESTS = [("hello ", "world"), ("the cat", " sat"), ("x", " y"),
            ("a longer piece of context", " here"), ("", " no context"),
            ("some context", ""), ("z" * 150, " truncated front"),
            ("ab", "c" * 140), ("q" * 40, " forty")]


@pytest.fixture(scope="module")
def lms():
    """(port cfg, port params, TorchCausalLM, JaxCausalLM) over the same
    float32 tiny model, batch 4."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab=256, layers=2),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab=256, layers=2),
                               dtype=torch.float32)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tp = convert.from_jax_params(jax_to_numpy(jp), device="cpu")
    tok = tasks_local.ByteTokenizer()
    port = TorchCausalLM(tp, tcfg, tok, batch_size=4, max_length=MAX_LENGTH,
                         device="cpu")
    ref = JaxCausalLM(jp, jcfg, jtasks_local.ByteTokenizer(), batch_size=4,
                      max_length=MAX_LENGTH)
    return tcfg, tp, port, ref


@pytest.fixture(scope="module")
def jax_loglikelihood(lms):
    return lms[3].loglikelihood(REQUESTS)


def _close(a, b, tol):
    return abs(a - b) <= tol * max(abs(b), 1e-30)


def test_loglikelihood_matches_jax(lms, jax_loglikelihood):
    """Mixed lengths, an empty context (scored after bos), an empty
    continuation (0, True), truncation from the front at max_length."""
    got = lms[2].loglikelihood(REQUESTS)
    assert len(got) == len(REQUESTS)
    for (ll, greedy), (rll, rgreedy), req in zip(got, jax_loglikelihood,
                                                 REQUESTS):
        assert _close(ll, rll, LL_TOL), (req, ll, rll)
        assert greedy == rgreedy, req
    assert got[5] == (0.0, True)


def test_batching_matches_single(lms):
    port = lms[2]
    batched = port.loglikelihood(REQUESTS)
    for req, (ll, greedy) in zip(REQUESTS, batched):
        [(one, g)] = port.loglikelihood([req])
        assert _close(ll, one, BATCH_TOL) and greedy == g, req


def test_loglikelihood_matches_manual_forward(lms):
    """One request against the port's own forward and log_softmax."""
    tcfg, tp, port, _ = lms
    tok = tasks_local.ByteTokenizer()
    ids = tok.encode("hello ") + tok.encode("world")
    logits, _ = llama.forward(tp, tcfg, torch.tensor([ids]))
    logp = torch.log_softmax(logits[0, :-1].float(), -1)
    tgt = torch.tensor(ids[1:])
    per_tok = logp.gather(1, tgt[:, None])[:, 0]
    n = len("world")
    [(ll, greedy)] = port.loglikelihood([("hello ", "world")])
    assert _close(ll, float(per_tok[-n:].sum()), 1e-6)
    assert greedy == bool((logp.argmax(-1)[-n:] == tgt[-n:]).all())


def test_rolling_matches_jax_and_windows(lms):
    _, _, port, ref = lms
    text = "some moderately long text " * 20     # 520 bytes: 5 windows
    requests = [(text,), "short", ("ab",), ("a",)]
    got = port.loglikelihood_rolling(requests)
    want = ref.loglikelihood_rolling(requests)
    for g, w in zip(got, want):
        assert _close(g, w, LL_TOL), (g, w)
    assert got[3] == 0.0 and got[0] < 0
    # the windows (max_length - 1 apart, one token of overlap) one by one
    ids = port._encode(text)
    step = MAX_LENGTH - 1
    total = 0.0
    for s in range(0, len(ids) - 1, step):
        [(lp, _)] = port._score_batch([ids[s:s + MAX_LENGTH]])
        total += float(lp.sum())
    assert _close(got[0], total, BATCH_TOL)


# one max_gen_toks but for the clamped one: JAX compiles a program for each
# (bucket, bucket + max_gen_toks)
GEN_REQUESTS = [("abcde", {"until": [], "max_gen_toks": 8}),
                ("The sky is", {"until": ["\n"], "max_gen_toks": 8}),
                ("q", {"until": "zz", "max_gen_toks": 8}),
                ("hello", {"until": [], "max_gen_toks": 100000}),
                ("", {"max_gen_toks": 8})]


@pytest.fixture(scope="module")
def jax_generations(lms):
    return lms[3].generate_until(GEN_REQUESTS)


def test_generate_until_matches_jax(lms, jax_generations):
    """Includes a string ``until`` and ``max_gen_toks`` far above
    ``max_length`` (clamped to ``max_length - MIN_BUCKET``). An empty
    context only has to run: the port begins it from bos, as
    ``loglikelihood`` does, where JAX's left-padded bucket attends to
    nothing but padding."""
    got = lms[2].generate_until(GEN_REQUESTS)
    assert got[:4] == jax_generations[:4]
    assert all(isinstance(t, str) for t in got)


def test_generate_until_is_greedy_generate(lms):
    tcfg, tp, port, _ = lms
    tok = tasks_local.ByteTokenizer()
    ids = tok.encode("abcde")
    ref = generate.generate(tp, tcfg, torch.tensor([ids]), max_new_tokens=8,
                            device="cpu")
    want = ref[0, len(ids):].tolist()
    got = port.greedy_tokens(ids, 8)
    # greedy_tokens stops before the tokenizer's eos (0)
    cut = want.index(0) if 0 in want else len(want)
    assert got == want[:cut]
    [text] = port.generate_until([("abcde", {"until": [],
                                             "max_gen_toks": 8})])
    assert text == tok.decode(got)


def test_stop_sequence(lms):
    port = lms[2]
    [full] = port.generate_until([("q", {"until": [], "max_gen_toks": 6})])
    assert len(full) >= 2
    stop = full[1]
    [cut] = port.generate_until([("q", {"until": [stop],
                                        "max_gen_toks": 6})])
    assert stop not in cut and full.startswith(cut)
    assert cut == full[:full.find(stop)]


def test_local_task_matches_jax(lms):
    _, _, port, ref = lms
    got = tasks_local.run_local_task(port, "local_mc")
    assert got == jtasks_local.run_local_task(ref, "local_mc")
    assert got["n"] == len(tasks_local.BUILTIN_MC_EXAMPLES)
    with pytest.raises(KeyError):
        tasks_local.run_local_task(port, "nope")


def test_code_route_matches_jax(lms, tmp_path):
    """The model's completions (8 tokens each) and their results are
    JAX's, in logs of the same fields."""
    _, _, port, ref = lms
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = code_eval.run_code_tasks(port, ["builtin"], max_gen_toks=8,
                                   log_dir=str(tmp_path / "port"))
    want = jcode_eval.run_code_tasks(ref, ["builtin"], max_gen_toks=8,
                                     log_dir=str(tmp_path / "jax"))
    assert got == want
    assert got["builtin"]["n_problems"] == len(code_eval.BUILTIN_PROBLEMS)
    logs = []
    for d in ("port", "jax"):
        with open(tmp_path / d / "code_builtin.json") as f:
            logs.append(json.load(f))
    # the error text names the candidate's temporary file
    assert [[(r["task_id"], c["completion"], c["passed"])
             for c in r["candidates"]] for r in logs[0]["records"]] == \
        [[(r["task_id"], c["completion"], c["passed"])
          for c in r["candidates"]] for r in logs[1]["records"]]
    assert logs[0]["metrics"] == logs[1]["metrics"]
    assert [r["task_id"] for r in logs[0]["records"]] == \
        [p["task_id"] for p in code_eval.BUILTIN_PROBLEMS]
    assert any(c["completion"] for r in logs[0]["records"]
               for c in r["candidates"])


def test_code_executor_and_estimator():
    prob = code_eval.BUILTIN_PROBLEMS[0]
    good = code_eval.build_program(prob, "    return a + b\n")
    bad = code_eval.build_program(prob, "    return a - b\n")
    assert code_eval.execute_candidate(good)["passed"]
    assert not code_eval.execute_candidate(bad)["passed"]
    loop = code_eval.build_program(prob, "    while True:\n        pass\n")
    res = code_eval.execute_candidate(loop, timeout=2.0)
    assert not res["passed"] and "timed out" in res["result"]
    for n, c, k in ((1, 1, 1), (1, 0, 1), (4, 2, 2), (10, 3, 5), (5, 0, 3)):
        assert code_eval.pass_at_k(n, c, k) == jcode_eval.pass_at_k(n, c, k)
    assert abs(code_eval.pass_at_k(4, 2, 2) - (1 - 1 / 6)) < 1e-12
    assert code_eval.truncate_completion("x = 1\ndef f():\n") == "x = 1"
    assert code_eval.STOP_WORDS == jcode_eval.STOP_WORDS
    assert code_eval.BUILTIN_PROBLEMS == jcode_eval.BUILTIN_PROBLEMS


def test_oracle_generator_scores_one():
    solutions = {"builtin/0": "    return a + b\n",
                 "builtin/1": "    return n % 2 == 0\n",
                 "builtin/2": "    return max(a, b, c)\n",
                 "builtin/3": "    return s[::-1]\n"}

    def oracle(prompt):
        for p in code_eval.BUILTIN_PROBLEMS:
            if p["prompt"] == prompt:
                return solutions[p["task_id"]] + "\ndef next_fn():\n"
        raise AssertionError("unknown prompt")

    assert code_eval.evaluate_code(oracle) == {"pass@1": 1.0,
                                               "n_problems": 4}


def test_lm_eval_gated_and_device_checked(lms):
    tcfg, tp, _, _ = lms
    with pytest.raises(lm_eval_adapter.LmEvalUnavailable):
        lm_eval_adapter.make_lm(tp, tcfg, tasks_local.ByteTokenizer(),
                                device="cpu")
    with pytest.raises(lm_eval_adapter.LmEvalUnavailable):
        lm_eval_adapter.simple_evaluate(tp, tcfg, None, ["piqa"],
                                        device="cpu")
    # entry points run on the GPU unless asked; these params are on the CPU
    with pytest.raises(ValueError, match="params are on cpu"):
        TorchCausalLM(tp, tcfg, tasks_local.ByteTokenizer())
    assert np.isfinite(lms[2].loglikelihood([("a", "b")])[0][0])
