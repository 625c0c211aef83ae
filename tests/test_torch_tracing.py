"""The port's spans (``any4_tpu_torch/tracing.py``) on the CPU, with tiny
random models of the port's own:

- with no profiler recording, a span is the shared no-op and opens no
  profiler event;
- under ``torch.profiler`` an engine's steps and a perplexity call give
  exactly the documented span names, nested as documented, and each
  prefill's span carries its request's uid, length and bucket;
- each span is an operator event, not a user annotation, so the profiler
  draws no copy of it on the device's timeline;
- every request's stamps are ordered (submitted, then prefilled);
- the engine's tokens are the same with the profiler on and off.
"""
import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from any4_tpu_torch import tracing
from any4_tpu_torch.evals import perplexity
from any4_tpu_torch.models import llama, mixtral
from any4_tpu_torch.serving.engine import Engine


@pytest.fixture(scope="module")
def moe():
    cfg = mixtral.MixtralConfig.tiny()
    return mixtral.init_params(cfg, seed=0, device="cpu"), cfg


@pytest.fixture(scope="module")
def dense():
    cfg = llama.LlamaConfig.tiny()
    return llama.init_params(cfg, seed=1, device="cpu"), cfg


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def _engine(model, prompts, max_new=4, **kw):
    params, cfg = model
    e = Engine(params, cfg, max_slots=2, max_ctx=64, page_size=8,
               device="cpu", **kw)
    uids = [e.submit(p, max_new_tokens=max_new) for p in prompts]
    return e, uids


def _profiled(fn, record_shapes=True):
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=record_shapes) as prof:
        out = fn()
    return out, [ev for ev in prof.events() if ev.name.startswith("any4.")]


def _tree(events):
    """{(span, its nearest enclosing any4 span or None)}."""
    def parent(ev):
        p = ev.cpu_parent
        while p is not None and not p.name.startswith("any4."):
            p = p.cpu_parent
        return None if p is None else p.name
    return {(ev.name[5:], parent(ev) and parent(ev)[5:]) for ev in events}


FORWARD = {("model.attn", None), ("model.ffn", None), ("model.head", None),
           ("attn.prefill", "model.attn"), ("linear", "model.attn"),
           ("moe.route", "model.ffn"), ("moe.experts", "model.ffn"),
           ("linear", "moe.route"), ("linear", "moe.experts"),
           ("linear", "model.head")}
ENGINE = {("engine.admit", None), ("engine.prefill", "engine.admit"),
          ("engine.read", "engine.admit"), ("kv.write", "engine.prefill"),
          ("engine.schedule", None), ("engine.decode", None),
          ("engine.graph", "engine.decode"),
          ("engine.read", None), ("engine.absorb", None),
          ("kv.write", "model.attn")} | {
    (s, "engine.prefill" if p is None else p) for s, p in FORWARD} | {
    (s, "engine.graph") for s, p in FORWARD if p is None}


def test_span_is_the_shared_noop_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler event was opened")
    monkeypatch.setattr(tracing, "_EVENT", refuse)
    for args in (None, {"uid": 1}):
        s = tracing.span("any4.linear", args)
        assert s is tracing._OFF
        with s:
            pass


def test_spans_nest_as_documented(moe):
    prompts = _prompts((5, 9))
    e, uids = _engine(moe, prompts)
    _, events = _profiled(lambda: [e.step(), e.step()])
    assert _tree(events) == ENGINE
    pre = [ev.kwinputs for ev in events if ev.name == "any4.engine.prefill"]
    assert pre == [{"uid": u, "len": len(p), "bucket": 16}
                   for u, p in zip(uids, prompts)]
    params, cfg = moe
    tokens = np.arange(96) % cfg.vocab_size
    _, events = _profiled(lambda: perplexity.eval_perplexity_chunked(
        params, cfg, tokens, seqlen=32, device="cpu"))
    assert _tree(events) == FORWARD


def test_spans_are_operator_events(dense):
    e, _ = _engine(dense, _prompts((5, 9)))
    _, events = _profiled(e.step)
    assert events
    assert not any(ev.is_user_annotation for ev in events)


def test_requests_are_stamped_in_order(dense):
    e, _ = _engine(dense, _prompts((5, 9, 3, 12)))
    done = e.run()
    assert len(done) == 4
    for r in done:
        assert r.t_submit is not None and r.t_prefill is not None
        assert r.t_submit <= r.t_prefill


@pytest.mark.parametrize("burst", [1, 4])
def test_tokens_equal_with_tracing_on_and_off(moe, burst):
    prompts = _prompts((5, 9, 3), seed=4)

    def serve():
        e, uids = _engine(moe, prompts)
        done = {r.uid: r.out_tokens for r in e.run(burst=burst)}
        return [done[u] for u in uids]
    off = serve()
    on, events = _profiled(serve, record_shapes=False)
    assert events and on == off


@pytest.mark.parametrize("burst", [1, 4])
def test_each_decode_step_opens_one_graph_span(moe, burst):
    """On the CPU every decode step runs eagerly: one ``any4.engine.graph``
    span a step (inside ``any4.engine.decode``, by the tree above), with
    its page-table bucket and action, and the engine's counts by action add
    up to its decode steps."""
    e, _ = _engine(moe, _prompts((5, 9, 3)))
    _, events = _profiled(lambda: e.run(burst=burst))
    args = [ev.kwinputs for ev in events if ev.name == "any4.engine.graph"]
    assert len(args) == e.decode_steps > 0
    assert {a["action"] for a in args} == {"eager"}
    assert {a["bucket"] for a in args} <= {1, 2, 4, 8}
    assert (e.eager_decodes, e.graph_replays, e.graph_captures) == \
        (e.decode_steps, 0, 0)
