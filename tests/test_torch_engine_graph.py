"""The serving engine's decode step replayed from CUDA graphs
(``serving/engine.py``: ``Engine._decode``, ``DecodeGraphs``).

On the CPU, with tiny random models of the port's own:

- the rule that decides where graphs run: never on the CPU or under a tp
  group, so every decode of a CPU engine is eager, a custom ``sample_fn``
  included;
- the engine's keys and actions, through a stand-in for ``DecodeGraphs``
  that runs each "graph" eagerly: a key is (slot count, page-table
  bucket), one engine's pools having one layout and dtype; it is captured
  once and replayed after,
  a key first met while the profiler records runs eagerly and is captured
  at its next untraced decode, and the tokens are the eager engine's;
- the launch counters: a replay adds exactly what its capture counted
  (the crediting functions on plain dicts).

On the card (marked ``card``; they skip here; run them there with
``python -m pytest --noconftest tests/test_torch_engine_graph.py``, since
``tests/conftest.py`` imports JAX), each against the same
engine made eager, token for token: a random any4 Llama and Mixtral (dense
dispatch in decode), and a W4A8 and a W8A8 Llama (their decode on the fused
kernels, whose mma body waits on its pre-pass by a programmatic dependent
launch), served past three page buckets with admissions and retirements
between, in the paged and the contiguous layout over bf16 and int8 pools;
bursts of 4 with the pipeline; a step under the profiler, whose replay's
kernels in the device trace are, name by name, the launches it credits;
and the launches a step.
"""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from any4_tpu_torch.models import fuse, llama, mixtral
from any4_tpu_torch.ops import gemv
from any4_tpu_torch.quant import api
from any4_tpu_torch.serving import engine as teng
from any4_tpu_torch.serving import kv_cache as kvc


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as ``test_torch_cli.one_torch_thread`` gives the
    other port test files; not imported from there, which imports JAX,
    since this file also runs on the card (``--noconftest``), where JAX is
    not installed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# prompts of 3-40 tokens (the longest admitted late) and up to 24 new ones
# at page_size 8: page-table buckets 2 to 8, with admissions and
# retirements between steps
LENGTHS = (3, 12, 7, 40, 25)
NEW = (24, 6, 20, 9, 14)


def _serve(e, prompts, news, **run):
    uids = [e.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    done = {r.uid: list(r.out_tokens) for r in e.run(**run)}
    return [done[u] for u in uids]


def _counts_add_up(e):
    assert e.graph_replays + e.graph_captures + e.eager_decodes \
        == e.decode_steps > 0


# --------------------------------------------------------------- CPU cases

@pytest.fixture(scope="module")
def tiny():
    cfg = llama.LlamaConfig.tiny()
    return llama.init_params(cfg, seed=2, device="cpu"), cfg


def test_graphs_run_on_cuda_without_a_tp_group():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert teng.captures_decode(cuda, None)
    assert not teng.captures_decode(cuda, object())
    assert not teng.captures_decode(cpu, None)


@pytest.mark.parametrize("sample", ["greedy", "custom"])
def test_a_cpu_engine_decodes_eagerly(tiny, sample):
    params, cfg = tiny
    kw = {} if sample == "greedy" else dict(
        sample_fn=lambda lg: torch.argmax(lg, dim=-1))
    e = teng.Engine(params, cfg, max_slots=2, max_ctx=64, page_size=8,
                    device="cpu", **kw)
    assert e._graphs is None
    _serve(e, _prompts(LENGTHS[:3]), NEW[:3])
    _counts_add_up(e)
    assert e.eager_decodes == e.decode_steps
    assert e.graph_replays == e.graph_captures == 0


class _Eager:
    """``DecodeGraphs``' interface with each "graph" run eagerly, so the
    engine's choice of action runs on the CPU."""

    def __init__(self):
        self.graphs, self.log = {}, []

    def capture(self, key, step, tokens, seq_lens, table):
        self.log.append(("capture", key))
        self.graphs[key] = step
        return step(tokens, seq_lens, table)

    def replay(self, key, tokens, seq_lens, table):
        self.log.append(("replay", key))
        return self.graphs[key](tokens, seq_lens, table)


LAYOUTS = [("paged", False), ("contig", False), ("paged", True)]


@pytest.mark.parametrize("layout,q8", LAYOUTS,
                         ids=["paged", "contig", "paged_int8"])
@pytest.mark.parametrize("slots", [2, 3])
def test_a_key_is_captured_once_then_replayed(tiny, layout, q8, slots):
    params, cfg = tiny
    prompts = _prompts(LENGTHS)

    def engine():
        return teng.Engine(params, cfg, max_slots=slots, max_ctx=64,
                           page_size=8, kv_layout=layout, kv_quantize=q8,
                           device="cpu")
    want = _serve(engine(), prompts, NEW)
    e = engine()
    e._graphs = stand_in = _Eager()
    assert _serve(e, prompts, NEW) == want
    keys = [k for _, k in stand_in.log]
    buckets = sorted({k[1] for k in keys})
    assert {k[0] for k in keys} == {slots} and len(buckets) >= 3
    assert all(len(k) == 2 for k in keys)
    captured = [k for a, k in stand_in.log if a == "capture"]
    assert sorted(captured, key=lambda k: k[1]) == \
        [(slots, b) for b in buckets]
    for i, (a, k) in enumerate(stand_in.log):
        assert a == ("replay" if k in keys[:i] else "capture")
    assert e.graph_captures == len(captured)
    assert e.graph_replays == len(keys) - len(captured) > 0
    assert e.eager_decodes == 0
    _counts_add_up(e)


def test_a_key_met_under_the_profiler_waits_for_an_untraced_decode(tiny):
    params, cfg = tiny
    # one page of 16 positions a slot: one key for every step below
    e = teng.Engine(params, cfg, max_slots=2, max_ctx=64, page_size=16,
                    device="cpu")
    e._graphs = stand_in = _Eager()
    e.submit(_prompts((5,))[0], max_new_tokens=8)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) \
            as prof:
        e.step()                        # admits; the key's first decode
        e.step()
    assert (e.eager_decodes, e.graph_captures) == (2, 0)
    actions = [ev.kwinputs["action"] for ev in prof.events()
               if ev.name == "any4.engine.graph"]
    assert actions == ["eager", "eager"]
    e.step()
    e.step()
    assert [a for a, _ in stand_in.log] == ["capture", "replay"]
    with profile(activities=[ProfilerActivity.CPU]):
        e.step()                        # a captured key replays traced too
    assert stand_in.log[-1][0] == "replay"
    _counts_add_up(e)


def test_a_replay_credits_its_captured_launches():
    counters = ({"a": 3, "b": 0}, {"x": 1})
    before = [dict(c) for c in counters]
    counters[0]["a"] += 2
    counters[1]["x"] += 5
    delta = teng.launch_delta(counters, before)
    assert delta == [{"a": 2}, {"x": 5}]
    for c, b in zip(counters, before):
        c.update(b)
    for _ in range(3):
        teng.credit_launches(counters, delta)
    assert counters == ({"a": 9, "b": 0}, {"x": 16})
    assert teng.launch_delta(counters, [dict(c) for c in counters]) == \
        [{}, {}]


# -------------------------------------------------------------- card cases

# widths the kernels take at g=128 (k a multiple of 128, head_dim 64)
WIDE = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=512)
# a model a kind and its format: the W4A8 and W8A8 Llama decode on the
# fused kernels (w4a8_fused, w8a8_fused), their mma body launched behind
# their pre-pass with programmatic stream serialization
KINDS = {"llama": "any4", "mixtral": "any4", "w4a8": "w4a8", "w8a8": "w8a8"}


def _card_model(kind, seed=0):
    if kind == "mixtral":
        cfg = mixtral.MixtralConfig(**WIDE, num_local_experts=4,
                                    num_experts_per_tok=2)
        params = mixtral.init_params(cfg, seed=seed, device="cuda")
    else:
        cfg = llama.LlamaConfig(**WIDE)
        params = llama.init_params(cfg, seed=seed, device="cuda")
    fmt = KINDS[kind]
    kw = dict(kmeans_iters=2) if fmt == "any4" else {}
    q = api.quantize_model(params, fmt=fmt, group_size=128, device="cuda",
                           **kw)
    return fuse.fuse_projections(q), cfg


@pytest.fixture(scope="module")
def card_models():
    """A random model of each kind, quantized and fused on the card; the
    card cases skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {k: _card_model(k) for k in KINDS}


def _pair(model, **kw):
    """The same engine twice: with graphs, and made eager."""
    params, cfg = model
    args = dict(max_slots=3, max_ctx=64, page_size=8, device="cuda")
    args.update(kw)
    graphs = teng.Engine(params, cfg, **args)
    eager = teng.Engine(params, cfg, **args)
    eager._graphs = None
    return graphs, eager


def _served_both(model, run=None, **kw):
    graphs, eager = _pair(model, **kw)
    prompts = _prompts(LENGTHS, vocab=model[1].vocab_size)
    got = _serve(graphs, prompts, NEW, **(run or {}))
    want = _serve(eager, prompts, NEW, **(run or {}))
    return got, want, graphs, eager


@pytest.mark.card
@pytest.mark.parametrize("layout,q8", LAYOUTS,
                         ids=["paged", "contig", "paged_int8"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_replays_give_the_eager_tokens(card_models, kind, layout, q8):
    got, want, e, eager = _served_both(card_models[kind], kv_layout=layout,
                                       kv_quantize=q8)
    assert got == want
    assert eager.eager_decodes == eager.decode_steps == e.decode_steps
    buckets = {k[1] for k in e._graphs.graphs}
    assert len(buckets) >= 3 and e.graph_captures == len(buckets)
    assert e.graph_replays > e.graph_captures and e.eager_decodes == 0
    _counts_add_up(e)


@pytest.mark.card
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pipelined_bursts_give_the_eager_tokens(card_models, kind):
    got, want, e, _ = _served_both(card_models[kind],
                                   run=dict(burst=4, pipeline=True))
    assert got == want
    assert e.graph_replays > 0
    _counts_add_up(e)


def _launches():
    return [dict(c) for c in teng.LAUNCH_COUNTERS]


# each module's kernels on the device, by name part
KERNEL_TABLES = (gemv.DEVICE_KERNELS, kvc.DEVICE_KERNELS)
PARTS = {p for t in KERNEL_TABLES for ps in t.values() for p in ps}


def _kernels_launched(delta):
    """The device kernels, by name part, that the launches of ``delta``
    (``engine.launch_delta``) run."""
    want = Counter()
    for table, d in zip(KERNEL_TABLES, delta):
        for name, n in d.items():
            for part in table[name]:
                want[part] += n
    return want


def _kernels_traced(prof):
    """The port's kernels in a profile's device trace, by name part."""
    return Counter(p for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   for p in PARTS if p in ev.name)


@pytest.mark.card
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_traced_step_runs_eagerly_then_replays(card_models, kind):
    # two pages of 16 positions: one key for every step
    e, eager = _pair(card_models[kind], page_size=16)
    prompts = _prompts((9, 20), vocab=512)
    for eng in (e, eager):
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        e.step()
    assert (e.eager_decodes, e.graph_captures) == (1, 0)
    e.step()
    e.step()
    assert (e.graph_captures, e.graph_replays) == (1, 1)
    before = _launches()
    with profile(activities=acts) as prof:
        e.step()
        torch.cuda.synchronize()
    assert e.graph_replays == 2
    # the kernels the replay ran on the device, by name, are the launches
    # it credited
    credited = teng.launch_delta(teng.LAUNCH_COUNTERS, before)
    want = _kernels_launched(credited)
    assert want["decode_kernel"] > 0 and _kernels_traced(prof) == want
    if KINDS[kind] != "any4":           # the fused kernels' pairs
        assert want["quantize_rows"] == want["a8_mma_"] > 0
    done = {r.uid: r.out_tokens for r in e.run()}
    want = {r.uid: r.out_tokens for r in eager.run()}
    assert done == want
    _counts_add_up(e)


@pytest.mark.card
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_replay_counts_the_launches_of_an_eager_step(card_models, kind):
    e, eager = _pair(card_models[kind])
    for eng in (e, eager):
        for p in _prompts((9, 14, 20), vocab=512):
            eng.submit(p, max_new_tokens=8)
        eng.step()                      # admits; captures the first key
    per_step = []
    for eng in (e, eager):
        before = _launches()
        eng.step()
        per_step.append(teng.launch_delta(teng.LAUNCH_COUNTERS, before))
    assert e.graph_replays == 1
    assert per_step[0] == per_step[1] and per_step[0][0] and per_step[0][1]
    if KINDS[kind] != "any4":
        assert set(per_step[0][0]) == {f"{kind}_fused"}
