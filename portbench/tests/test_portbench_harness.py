"""The command end to end at tiny sizes on the CPU: every cell of
``BENCHMARK.json`` runs, reports exactly its metrics, comes out correct,
and comes out not correct when the timed path is broken underneath."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import run, spec

from conftest import REPO

CELLS = [w["name"] for w in json.load(
    open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]
SEED = 2**31 + 11


def _run(root, cell, trace=False, seed=SEED, seconds=1.5):
    c = spec.load_cell(cell, root)
    return c, run.run_cell(c, seed, seconds, trace, "cpu",
                           time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_its_end_to_end_metrics(tiny_root, cell):
    c, r = _run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(c.limits)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_traced_reports_only_its_per_layer_metrics(tiny_root, cell):
    c, r = _run(tiny_root, cell, trace=True, seconds=2.0)
    assert r["correct"], r["checks"]
    names = {m["name"] for m in c.per_layer}
    assert set(r["metrics"]) <= names
    # the host-clock and counter readers find something on the CPU too
    host = {m["name"] for m in c.per_layer
            if m["source"] in ("host_clock", "program_counter")}
    assert host - {"admit_step_ms.chat", "admit_step_ms.rag"} <= set(
        r["metrics"])
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


def test_same_seed_same_inputs(tiny_root):
    from portbench import inputs
    c = spec.load_cell("mistral7b.chat", tiny_root)
    a, b = (inputs.client_requests(c.traffic, 512, SEED) for _ in "ab")
    assert all((x.prompt == y.prompt).all()
               and x.max_new_tokens == y.max_new_tokens
               for qa, qb in zip(a, b) for x, y in zip(qa, qb))
    fa, _ = inputs.draw_layer(c.config, SEED, 1, "cpu")
    fb, _ = inputs.draw_layer(c.config, SEED, 1, "cpu")
    assert all(torch.equal(fa[k].codes, fb[k].codes)
               and torch.equal(fa[k].scales, fb[k].scales) for k in fa)


def test_every_seed_gets_the_same_sizes_in_turn(tiny_root):
    """Two seeds deal the same clients' shares (the same lengths in the
    same turns) to other clients, with other ids."""
    from portbench import inputs
    c = spec.load_cell("mixtral8x7b.chat", tiny_root)
    runs = [inputs.client_requests(c.traffic, 512, s) for s in (1, 2**33)]

    def shares(q):
        return sorted(tuple((len(r.prompt), r.max_new_tokens) for r in cq)
                      for cq in q)
    assert shares(runs[0]) == shares(runs[1])
    first = [{(len(q[0].prompt), q[1].max_new_tokens): q[0].prompt
              for q in qs} for qs in runs]
    assert any((first[0][k] != first[1][k]).any() for k in first[0])


def test_main_refuses_without_a_card(tiny_root, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "ROOT", tiny_root)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) == 2
    assert capsys.readouterr().out == ""


def test_command_alone_in_a_directory_fails(tmp_path):
    import shutil
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(bench["command"] + [
        "--workload", CELLS[0], "--seed", "3", "--seconds", "1",
        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_names():
    code = ("import sys, portbench.run as r; import any4_tpu_torch; "
            "a = r.forbidden_modules(); sys.modules['jax'] = sys; "
            "sys.modules['any4_tpu.ops'] = sys; "
            "print(a, r.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.stdout.strip() == "[] ['any4_tpu', 'jax']", p.stderr


# ------------------------------------------------------------------ faults
def _alter_token(monkeypatch):
    from any4_tpu_torch.serving import engine
    orig = engine.Engine._read_tokens

    def altered(self, toks):
        out = orig(self, toks).copy()
        out.reshape(-1)[0] = (out.reshape(-1)[0] + 1) % self.cfg.vocab_size
        return out
    monkeypatch.setattr(engine.Engine, "_read_tokens", altered)


def _state_unchanged(monkeypatch):
    from any4_tpu_torch.serving import engine
    monkeypatch.setattr(engine.kvc, "write_tokens", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from any4_tpu_torch.serving import engine
    orig = engine._decode_impl

    def half(*a, **k):
        logits = orig(*a, **k)
        b = logits.shape[0]
        # the second half of the slots left out, the first half's mean in
        # its place
        logits[b // 2:] = logits[:b // 2].float().mean(0).to(logits.dtype)
        return logits
    monkeypatch.setattr(engine, "_decode_impl", half)


def _alter_answer(monkeypatch):
    from any4_tpu_torch.evals import perplexity
    orig = perplexity._nll
    monkeypatch.setattr(perplexity, "_nll",
                        lambda *a: orig(*a) * 1.01)


def _half_targets(monkeypatch):
    from any4_tpu_torch.evals import perplexity
    orig = perplexity.token_logprobs

    def half(logits, targets, *a):
        lp, hit = orig(logits, targets, *a)
        t = lp.shape[1] // 2
        lp[:, t:] = lp[:, :t].mean()
        return lp, hit
    monkeypatch.setattr(perplexity, "token_logprobs", half)


SERVE_FAULTS = {"token_altered": _alter_token,
                "state_unchanged": _state_unchanged,
                "half_batch": _half_batch}
SCORE_FAULTS = {"answer_altered": _alter_answer,
                "half_batch": _half_targets}
FAULTS = [(c, f) for c in CELLS for f in (
    SCORE_FAULTS if c.endswith("ppl2k") else SERVE_FAULTS)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                          fault):
    (SCORE_FAULTS if cell.endswith("ppl2k") else SERVE_FAULTS)[fault](
        monkeypatch)
    _, r = _run(tiny_root, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    p = subprocess.run(bench["command"] + [
        "--workload", cell, "--seed", "5", "--seconds", "5", "--trace",
        "0"], cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
