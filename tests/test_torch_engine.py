"""The port's serving engine against the JAX package's, on the CPU.

Parameters are made by the JAX package from a seed and carried across with
``convert.from_jax_params(..., device="cpu")``: the f32 tiny Llama, the same
model quantized to any4 at g=128 (2 layers), and a tiny f32 Gemma2-style
model (softcaps, sliding window, sandwich norms), which runs the dense
attention path. Both engines get the same prompts, made by numpy from a
seed. The dense f32 models must give the same tokens, token for token;
the any4 model is held by ``_both``'s tie rule (its teacher-forced logits
within ``QUANT_TIE`` of JAX's, and its tokens equal up to the first
near-tie). The cases mirror
``tests/test_serving.py`` (quantized embeddings and fused projections:
``tests/test_torch_fuse.py``; MoE layers: ``tests/test_torch_mixtral.py``;
the tensor-parallel engine: ``tests/test_torch_parallel.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from any4_tpu.models import llama as jllama
from any4_tpu.quant import api as japi
from any4_tpu.serving import engine as jeng
from any4_tpu_torch import convert
from any4_tpu_torch.models import llama
from any4_tpu_torch.ops import linear as lin
from any4_tpu_torch.parallel import tp as tpar
from any4_tpu_torch.serving import engine as teng
from any4_tpu_torch.serving import kv_cache as tkv
from test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from test_torch_convert import jax_to_numpy

GEMMA2 = dict(hidden_act="gelu_pytorch_tanh", rms_norm_offset=1.0,
              embed_scale=8.0, query_pre_attn_scalar=16.0,
              attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
              sliding_window=8, sandwich_norms=True, tie_word_embeddings=True,
              num_hidden_layers=4, head_dim=16)


def _pair(jp, jcfg):
    tcfg = dataclasses.replace(
        llama.LlamaConfig(), **{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(jcfg)
                                if f.name != "dtype"}, dtype=torch.float32)
    return jp, jcfg, convert.from_jax_params(jax_to_numpy(jp), device="cpu"), \
        tcfg


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab=256, layers=2),
                               dtype=jnp.float32)
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    any4 = japi.quantize_model(dense, fmt="any4", group_size=128,
                               kmeans_iters=2)
    gcfg = dataclasses.replace(jcfg, **GEMMA2)
    gemma = jllama.init_params(gcfg, jax.random.PRNGKey(5))
    return {"f32": _pair(dense, jcfg), "any4": _pair(any4, jcfg),
            "gemma2": _pair(gemma, gcfg)}


def _prompts(seed, lengths, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lengths]


def _serve(pkg, params, cfg, prompts, max_new, eos=None, run=None, **kw):
    """Submit ``prompts`` to a fresh engine of ``pkg`` and return each
    request's tokens, in submission order."""
    if pkg is teng:
        kw["device"] = "cpu"
    e = pkg.Engine(params, cfg, **kw)
    uids = [e.submit(p, max_new_tokens=max_new, eos_token_id=eos)
            for p in prompts]
    done = {r.uid: list(r.out_tokens) for r in e.run(**(run or {}))}
    return [done[u] for u in uids], e


# Share of max|logit| within which two tokens count as tied, for models
# whose kernels round activations (to bf16 or int8 codes). A few-ulp
# difference in f32 attention between XLA and PyTorch can flip one rounding
# of an activation; on the any4 model that grew to 2.9e-3 * max in the
# logits, where two tokens stood 2.7e-3 * max apart.
QUANT_TIE = 1e-2


def _teacher_forced(pkg, params, cfg, prompts, tokens):
    """One forward of ``pkg``'s model over each prompt followed by its
    generated ``tokens`` (right-padded into one batch; causal, so padding
    does not reach a real position); returns, per request, the f32 logits
    that predict each generated token, ``[len(tokens), vocab]``."""
    seqs = [np.concatenate([p, np.asarray(t[:-1], np.int32)])
            for p, t in zip(prompts, tokens)]
    ids = np.zeros((len(seqs), max(len(s) for s in seqs)), np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    if pkg is jeng:
        logits = np.asarray(jllama.forward(params, cfg, jnp.asarray(ids))[0],
                            np.float32)
    else:
        logits = llama.forward(params, cfg, torch.from_numpy(ids))[0] \
            .float().numpy()
    return [logits[i, len(p) - 1:len(p) - 1 + len(t)]
            for i, (p, t) in enumerate(zip(prompts, tokens))]


def _both(pair, prompts, max_new, tie=0.0, **kw):
    """Serve ``prompts`` on both engines. With ``tie`` 0 the tokens must be
    equal. Otherwise, along JAX's tokens, the port's forward must stay
    within ``tie * max|logit|`` of JAX's at every generated position, and
    the port's tokens must equal JAX's up to the first position where JAX's
    two best logits are closer than that; there the port's token must be
    one of JAX's within that distance of the top, and after it only the
    lengths count."""
    jp, jcfg, tp, tcfg = pair
    want, _ = _serve(jeng, jp, jcfg, prompts, max_new, **kw)
    got, e = _serve(teng, tp, tcfg, prompts, max_new, **kw)
    if not tie:
        assert got == want
        return got, e
    assert [len(t) for t in got] == [len(t) for t in want]
    ref = _teacher_forced(jeng, jp, jcfg, prompts, want)
    port = _teacher_forced(teng, tp, tcfg, prompts, want)
    for g, w, r, p in zip(got, want, ref, port):
        span = tie * np.abs(r).max(axis=-1)                  # [len]
        assert (np.abs(p - r).max(axis=-1) <= span).all()
        for i, (gt, wt) in enumerate(zip(g, w)):
            top = np.sort(r[i])[::-1]
            if top[0] - top[1] < span[i]:
                assert r[i][gt] >= top[0] - span[i]
                break
            assert gt == wt
    return got, e


CASES = {
    "one_request": dict(lengths=(6,), max_new=6,
                        kw=dict(max_slots=2, max_ctx=64, page_size=8)),
    "five_prompts_two_slots": dict(lengths=(4, 7, 5, 6, 3), max_new=4,
                                   kw=dict(max_slots=2, max_ctx=32,
                                           page_size=8)),
    "burst4": dict(lengths=(4, 7, 5, 6, 3), max_new=6,
                   kw=dict(max_slots=2, max_ctx=32, page_size=8,
                           run=dict(burst=4))),
    "contig_burst2": dict(lengths=(4, 7, 5), max_new=4,
                          kw=dict(max_slots=2, max_ctx=32, page_size=8,
                                  kv_layout="contig", run=dict(burst=2))),
    "int8_paged": dict(lengths=(5, 9), max_new=4,
                       kw=dict(max_slots=2, max_ctx=64, page_size=8,
                               kv_quantize=True)),
    "int8_contig_burst4": dict(lengths=(5, 9, 3), max_new=5,
                               kw=dict(max_slots=2, max_ctx=64, page_size=8,
                                       kv_quantize=True, kv_layout="contig",
                                       run=dict(burst=4))),
}


# The any4 model runs one case: the JAX engine interprets its Pallas kernels,
# which costs some 25 s of compilation per engine on the CPU.
@pytest.mark.parametrize("model,case", [("f32", c) for c in sorted(CASES)]
                         + [("any4", "burst4")])
def test_engine_matches_jax(models, model, case):
    c = CASES[case]
    got, e = _both(models[model], _prompts(1, c["lengths"]), c["max_new"],
                   tie=QUANT_TIE if model == "any4" else 0.0, **c["kw"])
    assert [len(t) for t in got] == [c["max_new"]] * len(c["lengths"])
    # every slot retired: its decode state is zeroed (see _decode_impl)
    assert not e.seq_lens.any() and not e.tokens.any()


def test_engine_eos_inside_burst_matches_jax(models):
    pair = models["f32"]
    prompt = _prompts(1, (4,))
    ref, _ = _serve(teng, pair[2], pair[3], prompt, 6, max_slots=1,
                    max_ctx=32, page_size=8)
    eos = ref[0][1]
    got, _ = _both(pair, prompt, 6, eos=eos, max_slots=1, max_ctx=32,
                   page_size=8, run=dict(burst=4))
    assert got[0][-1] == eos and len(got[0]) <= 2


@pytest.mark.parametrize("layout,depth", [("paged", 2), ("contig", 3),
                                          ("paged", 4)])
def test_engine_pipeline_matches_jax(models, layout, depth):
    got, _ = _both(models["f32"], _prompts(9, (4, 7, 5, 6)), 6, max_slots=2,
                   max_ctx=64, page_size=8, kv_layout=layout,
                   run=dict(burst=2, pipeline=True, pipeline_depth=depth))
    seq, _ = _serve(teng, models["f32"][2], models["f32"][3],
                    _prompts(9, (4, 7, 5, 6)), 6, max_slots=2, max_ctx=64,
                    page_size=8, kv_layout=layout, run=dict(burst=2))
    assert got == seq


def test_engine_oversized_prompt_matches_jax(models):
    """A prompt longer than max_ctx is cut to its last max_ctx - 1 tokens
    and served; it does not block the queue."""
    long, short = _prompts(5, (50, 4))
    got, _ = _both(models["f32"], [long, short], 2, max_slots=1, max_ctx=32,
                   page_size=8)
    tail, _ = _serve(teng, models["f32"][2], models["f32"][3], [long[-31:]],
                     2, max_slots=1, max_ctx=32, page_size=8)
    assert got[0] == tail[0]


@pytest.mark.parametrize("layout", ["paged", "contig"])
def test_gemma2_engine_matches_jax(models, layout):
    _both(models["gemma2"], _prompts(3, (5, 11, 7)), 12, max_slots=2,
          max_ctx=64, page_size=8, kv_layout=layout, run=dict(burst=4))


def test_buckets_and_sizes_match_jax(models):
    """Power-of-two prefill buckets, power-of-two context-table buckets,
    and max_ctx rounded up to whole 512-token blocks in the contig
    layout."""
    jp, jcfg, tp, tcfg = models["f32"]
    for layout, max_ctx, ps in (("paged", 600, 16), ("contig", 600, 16),
                                ("contig", 64, 8), ("paged", 100, 8)):
        je = jeng.Engine(jp, jcfg, max_slots=3, max_ctx=max_ctx,
                         page_size=ps, kv_layout=layout)
        te = teng.Engine(tp, tcfg, max_slots=3, max_ctx=max_ctx,
                         page_size=ps, kv_layout=layout, device="cpu")
        assert (te.max_ctx, te.pps) == (je.max_ctx, je.pps)
        assert te.max_ctx % (512 if layout == "contig" else ps) == 0
        assert te.cache.k_pages[0].shape == je.cache.k_pages[0].shape
        assert [te._bucket(n) for n in (1, 16, 17, 100, 5000)] == \
            [je._bucket(n) for n in (1, 16, 17, 100, 5000)]
        for lens in ([0, 0, 0], [3, 0, 40], [0, 90, 7]):
            for e in (je, te):
                e.slots = [object() if n else None for n in lens]
                e.seq_lens[:] = lens
            for extra in (1, 2, 9):
                np.testing.assert_array_equal(
                    te._ctx_table(extra).numpy(),
                    np.asarray(je._ctx_table(extra)))


@pytest.mark.parametrize("layout", ["paged", "contig"])
def test_prefill_padding_targets(models, layout):
    """Padded prefill positions go to page 0 (the sink) in the paged
    layout and into the slot's own region in the contiguous one; real
    positions land where the JAX package puts them."""
    jp, jcfg, tp, tcfg = models["f32"]
    ps, pool_pages = 8, 6
    row = np.asarray([3, 4, 0], np.int32) if layout == "paged" else \
        np.asarray([3, 4, 5], np.int32)
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :5] = _prompts(2, (5,))[0]
    cache = tkv.PagedKVCache.create(tcfg, pool_pages, ps, device="cpu")
    teng._prefill_impl(tp, tcfg, torch.from_numpy(prompt), 5, cache.k_pages,
                       cache.v_pages, torch.from_numpy(row), ps,
                       kv_layout=layout)
    jc = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype),
        [jnp.zeros((2, pool_pages, ps, 16))] * 2)
    _, jk, _ = jeng._prefill_impl(jp, jcfg, jnp.asarray(prompt), 5, jc, jc,
                                  jnp.asarray(row), ps, kv_layout=layout)
    got = cache.k_pages[0].numpy()
    ref = np.asarray(jk[0])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    written = np.abs(got).sum(axis=(0, 3)) != 0           # [pages, ps]
    if layout == "paged":
        assert written[3, :5].all() and not written[3, 5:].any()
        assert written[0, 0] and not written[4].any()     # sink took them
    else:
        assert written[3].all() and written[4].all()      # own region
        assert not written[0].any() and not written[5].any()


def test_decode_clamps_stale_seq_len(models):
    """An inactive slot whose seq_len ran past the bucketed table writes
    into its own last bucketed page, never another slot's."""
    jp, jcfg, tp, tcfg = models["f32"]
    e = teng.Engine(tp, tcfg, max_slots=2, max_ctx=512, page_size=8,
                    kv_layout="contig", device="cpu")
    before = [k.clone() for k in e.cache.k_pages]
    tables = torch.from_numpy(e.alloc.table[:, :2].copy())   # 16 positions
    teng._decode_impl(tp, tcfg, torch.tensor([5, 7], dtype=torch.int32),
                      torch.tensor([3, 300], dtype=torch.int32), tables,
                      e.cache.k_pages, e.cache.v_pages, 8, kv_layout="contig")
    for k0, k1 in zip(before, e.cache.k_pages):
        changed = (k0 != k1).any(dim=(0, 3))                 # [pages, ps]
        assert changed[0, 3]                                 # slot 0, pos 3
        assert changed[e.pps + 1, 300 % 8]                   # slot 1, clamped
        assert int(changed.sum()) == 2


def test_engine_leaves_out_what_is_not_ported(models, tmp_path):
    jp, jcfg, tp, tcfg = models["f32"]
    # tensor parallelism (item 12) is served: a one-rank world's TP engine
    # gives the single engine's tokens (more ranks:
    # tests/test_torch_parallel.py); mesh without param_spec is refused
    with pytest.raises(ValueError, match="together"):
        teng.Engine(tp, tcfg, mesh=object(), device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mesh = tpar.make_mesh(dp=1, tp=1, device="cpu")
        local, specs = tpar.shard_params(tp, mesh)
        prompts = _prompts(2, (5, 11))
        want, _ = _serve(teng, tp, tcfg, prompts, 4, max_slots=2,
                         max_ctx=32, page_size=8)
        got, e = _serve(teng, local, tcfg, prompts, 4, max_slots=2,
                        max_ctx=32, page_size=8, mesh=mesh, param_spec=specs)
        assert got == want and e.mesh is mesh
    finally:
        dist.destroy_process_group()
    # MoE layers (item 9) are served (tests/test_torch_mixtral.py)
    moe = {**tp, "layers": [{**tp["layers"][0], "experts": {}}]}
    assert teng.Engine(moe, tcfg, device="cpu").params is moe
    # a quantized table (item 8) is served: looked up and, tied, the head
    qt = lin.quantize_tensor(tp["embed_tokens"], "nf4", 64)
    got, _ = _serve(teng, {**tp, "embed_tokens": qt}, tcfg,
                    _prompts(1, (4, 6)), 3, max_slots=2, max_ctx=32,
                    page_size=8)
    assert [len(t) for t in got] == [3, 3]
    with pytest.raises(ValueError, match="params are on cpu"):
        teng.Engine(tp, tcfg)                       # default device: cuda
