"""The port's tensor parallelism (``any4_tpu_torch/parallel/tp.py``) against
the JAX package's, on the CPU.

One gloo world of 4 CPU ranks (``tests/torch_tp_worker.py``, one process a
rank, torch on one thread, a 180 s timeout each) runs every case of the
module once, as dp=2 x tp=2 (``dp2tp2``) and as tp=4 (``tp4``). Each
case's JAX reference comes from ``tp.make_tp_forward`` on 4 of conftest's 8
virtual devices with the same mesh, computed once a module, on the same
seeded inputs: the JAX package makes and quantizes the weights, and
``convert.from_jax_params`` carries them across. The cases mirror
``tests/test_parallel.py``: dense float32 (Llama, column and row biases,
the unstacked MoE, the decode step with the cache) within 1e-4 *
max|ref|; bf16, int4 g=32 with an int8-quantized tied table, fused any4
(``kmeans_iters=3``) and W4A8 (each rank scales its own k slice's
activations), with row-parallel weights packed in 4 segments
(``row_parallel_shards``), within 2e-2 * max (the port's kernels round
activations to bf16, and the packages sum the ranks' partials in their
own order and precision). The 4-segment weights also run at dp=2 x tp=2,
two segments a rank, against JAX's tp=4 run. The TP engine is held
against the port's single engine: dense float32 token for token (paged
and contiguous, float and int8 pools), any4 by the tie rule of
``tests/test_torch_engine.py``. Stacked experts and a ``dp * tp`` that is
not the world are refused.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from any4_tpu.models import fuse as jfuse
from any4_tpu.models import llama as jllama
from any4_tpu.models import mixtral as jmixtral
from any4_tpu.parallel import tp as jtp
from any4_tpu.quant import api as japi
from any4_tpu_torch import convert
from any4_tpu_torch.models import fuse, llama, mixtral
from any4_tpu_torch.ops import linear as lin
from any4_tpu_torch.parallel import tp
from any4_tpu_torch.quant import api
from any4_tpu_torch.serving import engine as teng
from test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from test_torch_convert import assert_close_max, jax_to_numpy

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_tp_worker.py")
WORLD = 4
LAYOUTS = {"dp2tp2": (2, 2), "tp4": (1, 4)}
F32_TOL, QUANT_TOL = 1e-4, 2e-2
# the engine's tie rule (tests/test_torch_engine.py): the TP forward's
# teacher-forced logits within QUANT_TIE * max of the single forward's,
# tokens equal up to the first near-tie of the single engine's logits
QUANT_TIE = 1e-2


def _cfg(cls=jllama.LlamaConfig, **kw):
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=4, head_dim=8, tie_word_embeddings=True,
                dtype=jnp.float32)
    return cls(**{**base, **kw})


def _port_cfg(jcfg):
    """The port's config of a JAX config (the same fields, float32 or bf16
    as the JAX one)."""
    cls = (mixtral.MixtralConfig if isinstance(jcfg, jmixtral.MixtralConfig)
           else llama.LlamaConfig)
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg) if f.name != "dtype"},
               dtype=(torch.bfloat16 if jcfg.dtype == jnp.bfloat16
                      else torch.float32))


def _jax_mesh(layout):
    dp, tpn = LAYOUTS[layout]
    return jtp.make_mesh(dp=dp, tp=tpn, devices=jax.devices()[:WORLD])


def _jax_tp(params, jcfg, layout, ids, forward_fn=None, fused=False):
    mesh = _jax_mesh(layout)
    sharded, specs = jtp.shard_params(params, mesh,
                                      cfg=jcfg if fused else None)
    fwd = jtp.make_tp_forward(jcfg, mesh, specs, forward_fn=forward_fn)
    return np.asarray(fwd(sharded, jnp.asarray(ids)), np.float32)


def _jax_decode(params, jcfg, layout, tokens, max_len):
    mesh = _jax_mesh(layout)
    sharded, specs = jtp.shard_params(params, mesh)
    step = jtp.make_tp_forward(jcfg, mesh, specs, with_cache=True)
    caches = [tuple(jax.device_put(c, NamedSharding(
        mesh, P("dp", None, "tp", None))) for c in kv)
        for kv in jllama.init_kv_caches(jcfg, tokens.shape[1], max_len)]
    out = []
    for pos, tok in enumerate(tokens):
        logits, caches = step(sharded, jnp.asarray(tok), jnp.int32(pos),
                              caches)
        out.append(np.asarray(logits, np.float32))
    return np.stack(out)


def _ids(seed, shape, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _port(params):
    return convert.from_jax_params(jax_to_numpy(params), device="cpu")


def _with_biases(params, jcfg):
    params = japi._copy_tree(params)
    key = jax.random.PRNGKey(7)
    hd, nq, nkv = jcfg.head_dim_, jcfg.num_attention_heads, \
        jcfg.num_key_value_heads
    for layer in params["layers"]:
        k1, k2, k3, k4, key = jax.random.split(key, 5)
        layer["q_bias"] = jax.random.normal(k1, (nq * hd,), jnp.float32)
        layer["k_bias"] = jax.random.normal(k2, (nkv * hd,), jnp.float32)
        layer["v_bias"] = jax.random.normal(k3, (nkv * hd,), jnp.float32)
        layer["o_bias"] = jax.random.normal(k4, (jcfg.hidden_size,),
                                            jnp.float32)
    return params


def _forward_cases():
    """``(name, layout, JAX params, JAX config, ids, forward, fused, tol)``
    of every forward case."""
    cfg = _cfg()
    dense = jllama.init_params(cfg, jax.random.PRNGKey(0))
    biased = _with_biases(dense, cfg)
    any4 = japi.quantize_model(dense, fmt="any4", group_size=32,
                               kmeans_iters=3, row_parallel_shards=4)
    # int4 g=32 with the int8-quantized tied table (looked up on every
    # rank, the head replicated)
    int4 = japi.quantize_model(dense, fmt="int4", group_size=32,
                               row_parallel_shards=4,
                               quantize_embeddings="int8")
    wide = _cfg(hidden_size=512, intermediate_size=512, num_hidden_layers=1,
                head_dim=64)
    w4a8 = japi.quantize_model(
        jllama.init_params(wide, jax.random.PRNGKey(39)), fmt="w4a8",
        group_size=128, row_parallel_shards=4)
    moe_cfg = _cfg(jmixtral.MixtralConfig, num_local_experts=4,
                   num_experts_per_tok=2)
    moe = jmixtral.init_params(moe_cfg, jax.random.PRNGKey(70))
    bf16_cfg = dataclasses.replace(cfg, dtype=jnp.bfloat16)
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), dense)
    mx = jmixtral.forward
    ids = _ids(1, (4, 8))
    return [
        ("dense_f32", "dp2tp2", dense, cfg, ids, None, False, F32_TOL),
        ("dense_f32", "tp4", dense, cfg, ids, None, False, F32_TOL),
        ("dense_bf16", "dp2tp2", bf16, bf16_cfg, ids, None, False,
         QUANT_TOL),
        ("biases", "dp2tp2", biased, cfg, ids, None, False, F32_TOL),
        ("biases", "tp4", biased, cfg, ids, None, False, F32_TOL),
        ("int4_qemb_S4", "tp4", int4, cfg, ids, None, False, QUANT_TOL),
        ("fused_any4_S4", "tp4", jfuse.fuse_projections(any4), cfg, ids,
         None, True, QUANT_TOL),
        ("w4a8_S4", "tp4", w4a8, wide, ids, None, False, QUANT_TOL),
        ("moe_f32", "dp2tp2", moe, moe_cfg, ids, mx, False, F32_TOL),
        ("moe_f32", "tp4", moe, moe_cfg, ids, mx, False, F32_TOL),
    ], dense, cfg, moe, moe_cfg


# cases whose port run splits the weights in another layout than the JAX
# reference's (the same function; the ranks' partials summed in another
# order): port key -> JAX key
OTHER_LAYOUT = {"int4_qemb_S4@dp2tp2": "int4_qemb_S4@tp4",
                "fused_any4_S4@dp2tp2": "fused_any4_S4@tp4"}


def _single_engine(params, cfg, prompts, max_new, engine, run):
    e = teng.Engine(params, cfg, device="cpu", **engine)
    uids = [e.submit(p, max_new_tokens=max_new) for p in prompts]
    done = {r.uid: list(r.out_tokens) for r in e.run(**run)}
    return [done[u] for u in uids]


def _forced_ids(prompts, tokens):
    """Each prompt with its generated tokens but the last, right-padded
    into one batch (causal, so padding reaches no real position)."""
    seqs = [np.concatenate([p, np.asarray(t[:-1], np.int32)])
            for p, t in zip(prompts, tokens)]
    ids = np.zeros((len(seqs), max(len(s) for s in seqs)), np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    return torch.from_numpy(ids)


def _forced(logits, prompts, tokens):
    return [logits[i, len(p) - 1:len(p) - 1 + len(t)]
            for i, (p, t) in enumerate(zip(prompts, tokens))]


SERVE_CASES = {   # name -> (weights, mesh, engine kwargs, run kwargs)
    "serve_f32_paged": ("dense", "dp2tp2", dict(kv_layout="paged"),
                        dict(burst=4)),
    "serve_f32_contig_q8": ("dense", "tp4", dict(kv_layout="contig",
                                                  kv_quantize=True),
                            dict(burst=1)),
    "serve_any4_paged_q8": ("any4", "dp2tp2", dict(kv_layout="paged",
                                                   kv_quantize=True),
                            dict(burst=4, pipeline=True)),
}


def _run_world(cases, tmp):
    """Run ``cases`` on a 4-rank gloo world; returns each rank's results."""
    path = os.path.join(tmp, "cases.pt")
    torch.save(cases, path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    outs = [os.path.join(tmp, f"out{r}.pt") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, path, str(r), str(WORLD), address, outs[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out)
    for r, (p, out) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert f"rank {r} OK" in out
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's JAX reference (or the port's single engine), and the 4
    ranks' results."""
    fcases, dense, cfg, moe, moe_cfg = _forward_cases()
    cases, refs = [], {}
    for name, layout, jp, jcfg, ids, fwd, fused, tol in fcases:
        key = f"{name}@{layout}"
        refs[key] = (_jax_tp(jp, jcfg, layout, ids, fwd, fused), tol)
        case = dict(name=key, run_as="forward", mesh=layout,
                    params=_port(jp), cfg=_port_cfg(jcfg),
                    ids=torch.from_numpy(ids),
                    model="mixtral" if fwd else "llama")
        cases.append(case)
        for other, jkey in OTHER_LAYOUT.items():
            if jkey == key:     # S=4 segments, two a rank at tp=2
                refs[other] = refs[key]
                cases.append({**case, "name": other, "mesh": "dp2tp2"})
    tokens = _ids(2, (3, 4))
    for layout in LAYOUTS:
        key = f"decode@{layout}"
        refs[key] = (_jax_decode(dense, cfg, layout, tokens, 8), F32_TOL)
        cases.append(dict(name=key, run_as="decode", mesh=layout,
                          params=_port(dense), cfg=_port_cfg(cfg),
                          tokens=torch.from_numpy(tokens), max_len=8))
    # the TP engine against the port's single engine
    tcfg = _port_cfg(cfg)
    weights = {"dense": _port(dense),
               "any4": api.quantize_model(_port(dense), fmt="any4",
                                          group_size=32, kmeans_iters=3,
                                          row_parallel_shards=2,
                                          device="cpu")}
    prompts = [_ids(3 + i, (n,)) for i, n in enumerate((5, 9, 17, 30))]
    for name, (w, layout, eng, run) in SERVE_CASES.items():
        eng = dict(max_slots=3, max_ctx=64, page_size=8, **eng)
        toks = _single_engine(weights[w], tcfg, prompts, 6, eng, run)
        ids = _forced_ids(prompts, toks)
        refs[name] = (toks, llama.forward(weights[w], tcfg, ids)[0])
        cases.append(dict(name=name, run_as="serve", mesh=layout,
                          params=weights[w], cfg=tcfg, prompts=prompts,
                          max_new=6, engine=eng, run=run, forced_ids=ids))
    stacked = fuse.stack_experts(_port(moe))
    cases += [dict(name="stacked@tp4", run_as="stacked", mesh="tp4",
                   params=stacked, cfg=_port_cfg(moe_cfg),
                   ids=torch.from_numpy(_ids(1, (4, 8))), raises=True),
              dict(name="bad_mesh", run_as="bad_mesh", mesh="tp4",
                   raises=True)]
    return refs, _run_world(cases, str(tmp_path_factory.mktemp("tp")))


FORWARD_KEYS = [f"{c[0]}@{c[1]}" for c in (
    ("dense_f32", "dp2tp2"), ("dense_f32", "tp4"), ("dense_bf16", "dp2tp2"),
    ("biases", "dp2tp2"), ("biases", "tp4"), ("int4_qemb_S4", "tp4"),
    ("int4_qemb_S4", "dp2tp2"), ("fused_any4_S4", "tp4"),
    ("fused_any4_S4", "dp2tp2"), ("w4a8_S4", "tp4"), ("moe_f32", "dp2tp2"),
    ("moe_f32", "tp4"), ("decode", "dp2tp2"), ("decode", "tp4"))]


@pytest.mark.parametrize("key", FORWARD_KEYS)
def test_tp_forward_matches_jax_tp(world, key):
    refs, ranks = world
    ref, tol = refs[key]
    got = ranks[0][key]
    assert tuple(got.shape) == ref.shape
    assert_close_max(got, ref, tol)
    # the logits come out whole, and alike, on every rank
    for r in ranks[1:]:
        assert torch.equal(r[key], got)


@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_tp_engine_matches_single_engine(world, name):
    refs, ranks = world
    want, single_logits = refs[name]
    got = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["tokens"] == got["tokens"]
    prompts = [_ids(3 + i, (n,)) for i, n in enumerate((5, 9, 17, 30))]
    if SERVE_CASES[name][0] == "dense":
        assert got["tokens"] == want
        assert_close_max(got["forced"], single_logits, F32_TOL)
        return
    ref = _forced(single_logits.float().numpy(), prompts, want)
    tp_lg = _forced(got["forced"].float().numpy(), prompts, want)
    for g, w, lr, lt in zip(got["tokens"], want, ref, tp_lg):
        scale = float(np.abs(lr).max())
        assert np.abs(lt - lr).max() <= QUANT_TIE * scale
        assert len(g) == len(w)
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                top2 = np.sort(lr[j])[-2:]
                assert top2[1] - top2[0] < QUANT_TIE * scale
                assert lr[j][a] >= top2[1] - QUANT_TIE * scale
                break


def test_refusals(world):
    """Stacked experts at tp > 1 and a mesh that is not the world raise
    ValueError on every rank."""
    _, ranks = world
    for r in ranks:
        assert r["stacked@tp4"].startswith("ValueError: stacked experts")
        assert r["bad_mesh"].startswith("ValueError: dp*tp=12")


def test_param_specs_structure():
    jp = jllama.init_params(_cfg(), jax.random.PRNGKey(0))
    q = api.quantize_model(_port(jp), fmt="any4", group_size=32,
                           kmeans_iters=2, row_parallel_shards=2,
                           device="cpu")
    specs = tp.param_specs(q)
    qspec, ospec = specs["layers"][0]["q_proj"], specs["layers"][0]["o_proj"]
    assert (qspec.packed, qspec.scales, qspec.zeros, qspec.lut) == (
        ("tp", None), (None, "tp"), (None, "tp"), ("tp", None))
    assert (ospec.packed, ospec.scales, ospec.lut) == (
        (None, "tp"), ("tp", None), (None, None))
    assert specs["embed_tokens"] == (None, None)
    assert specs["layers"][0]["input_layernorm"] == (None,)
    # JAX's specs of a row-layout tree name the same axes (its packed [n,
    # kw] is the port's layout there)
    jq = jtp.param_specs(japi.quantize_model(
        jp, fmt="int4", group_size=32, layout="row"))["layers"][0]
    pq = tp.param_specs(_port(japi.quantize_model(
        jp, fmt="int4", group_size=32, layout="row")))["layers"][0]
    for nm in ("q_proj", "o_proj"):
        assert (tuple(jq[nm].packed), tuple(jq[nm].scales)) == (
            pq[nm].packed, pq[nm].scales)


def test_check_shards_refuses_a_tree_its_specs_do_not_describe():
    """``check_shards`` (run by ``make_tp_forward`` and the TP engine)
    accepts the tree the specs were made from and refuses a dequantized
    copy or a tree with other leaves."""
    jp = jllama.init_params(_cfg(), jax.random.PRNGKey(0))
    q = api.quantize_model(_port(jp), fmt="int4", group_size=32,
                           device="cpu")
    specs = tp.param_specs(q)
    tp.check_shards(q, specs)
    deq = {**q, "layers": [{**q["layers"][0], "q_proj": lin.dequantize_tensor(
        q["layers"][0]["q_proj"], torch.float32)}, *q["layers"][1:]]}
    with pytest.raises(ValueError, match="q_proj: the leaf does not match"):
        tp.check_shards(deq, specs)
    with pytest.raises(ValueError, match="different leaves"):
        tp.check_shards({**q, "layers": q["layers"][:1]}, specs)


def test_local_shards_are_whole_weights():
    """Rank r's slice of a weight packed in S segments is a weight of its
    own: its dequantization is the columns (or rows) it holds."""
    w = torch.randn(64, 2560, generator=torch.Generator().manual_seed(0))
    full = lin.quantize_tensor(w, "int4", 128, row_shards=4)
    dense = lin.dequantize_tensor(full, torch.float32)
    for tpn, shards in ((2, 2), (4, 1)):
        for r in range(tpn):
            loc = tp._local_qt(full, "row", tpn, r)
            assert loc.row_shards == shards and loc.shape == (64, 2560 // tpn)
            torch.testing.assert_close(
                lin.dequantize_tensor(loc, torch.float32),
                dense[:, r * 2560 // tpn:(r + 1) * 2560 // tpn], rtol=0,
                atol=0)
            col = tp._local_qt(full, "col", tpn, r)
            torch.testing.assert_close(
                lin.dequantize_tensor(col, torch.float32),
                dense[r * 64 // tpn:(r + 1) * 64 // tpn], rtol=0, atol=0)
    # one padded segment cannot be split at its padding
    with pytest.raises(ValueError, match="row_parallel_shards a multiple"):
        tp._local_qt(lin.quantize_tensor(w, "int4", 128), "row", 2, 0)


def test_interleave_rows_matches_jax():
    """The fused reshard's row order is the JAX package's, and a quad
    format whose chunks split a word is refused as there."""
    k = 512
    rng = np.random.default_rng(4)
    wq, wk = (rng.standard_normal((n, k)).astype(np.float32)
              for n in (64, 32))
    parts = [lin.quantize_tensor(torch.from_numpy(w), "w4a8", 128)
             for w in (wq, wk)]
    fused = fuse.concat_quantized(parts)
    out = tp._interleave_rows(fused, [64, 32], 2)
    order = np.concatenate([np.arange(0, 32), np.arange(64, 80),
                            np.arange(32, 64), np.arange(80, 96)])
    dense = torch.cat([lin.dequantize_tensor(p, torch.float32)
                       for p in parts])
    assert torch.equal(lin.dequantize_tensor(out, torch.float32),
                       dense[order])
    with pytest.raises(ValueError, match="% 4 == 0"):
        tp._interleave_rows(fused, [64, 32], 16)
