"""The port's KV cache and decode attention against the JAX package's, on
the CPU, with inputs made by numpy from a seed and given to both.

Bars:
- ``flash_paged_decode`` plain vs the interpreted Pallas kernel: f32 and
  bf16 pools within rtol 2e-4 / atol 2e-5 (both compute in f32), int8
  pools within atol 1e-5 (the JAX suite's own bar for that kernel);
- ``flash_contig_decode`` plain vs the interpreted Pallas kernel: f32
  pools within rtol 2e-4 / atol 2e-5; bf16 and int8 pools within
  1e-2 * max|ref|, for the bf16 roundings of q and p, which the two sides
  take against running maxima of different blocks (JAX's 512-token blocks,
  the port's 64-token tiles);
- the dense paths and the CPU routes of ``paged_attention`` /
  ``contig_attention``: within 1e-5 * max|ref| in f32;
- ``write_tokens`` into f32, bf16 and int8 pools, ``PageAllocator`` and the
  int8 codes' saturation: bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.paged_attention import (
    quantization_utils as qu)

from any4_tpu.serving import kv_cache as jkv
from any4_tpu_torch.serving import kv_cache as tkv
from test_torch_convert import assert_close_max

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _q8(x):
    """JAX's own int8 writer on a float array ``[..., d]``: codes and the
    per-row amax scales ``[...]``."""
    amax = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-6)
    codes = np.array(qu.to_int8(jnp.asarray(x), jnp.asarray(amax)))
    return codes, amax[..., 0].astype(np.float32)


def _pools(x, kind):
    """The same pool as a (JAX, port) pair: ``kind`` f32/bf16 rounds the
    float array, int8 quantizes it with JAX's writer."""
    if kind == "int8":
        codes, scales = _q8(x)
        return ((jnp.asarray(codes), jnp.asarray(scales)),
                (torch.from_numpy(codes), torch.from_numpy(scales)))
    jdt, tdt = DTYPES[kind]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(y):
    return np.asarray(jnp.asarray(y, jnp.float32)) if not isinstance(
        y, torch.Tensor) else y.float().numpy()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [32, 64])
def test_flash_paged_decode_matches_jax(hd, kind):
    h, P, ps = 2, 9, 8
    b, nq = 2, 4
    rng = np.random.RandomState(1)
    kp = rng.randn(h, P, ps, hd).astype(np.float32)
    vp = rng.randn(h, P, ps, hd).astype(np.float32)
    q = rng.randn(b, nq, hd).astype(np.float32)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    lens = np.asarray([7, 25], np.int32)
    (jk, tk), (jv, tv) = _pools(kp, kind), _pools(vp, kind)
    ref = jkv.flash_paged_decode(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                 jnp.asarray(table), interpret=True)
    got = tkv.flash_paged_decode(torch.from_numpy(q), tk, tv,
                                 torch.from_numpy(lens),
                                 torch.from_numpy(table))
    assert got.shape == (b, nq, hd) and got.dtype == torch.float32
    if kind == "int8":
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd,ctx_bucket,lens", [
    (32, 1024, (700, 130)), (64, 512, (300, 512))])
def test_flash_contig_decode_matches_jax(hd, ctx_bucket, lens, kind):
    b, h, rep, max_ctx = 2, 2, 2, 1024
    rng = np.random.RandomState(4)
    kf = rng.standard_normal((h, b * max_ctx, hd)).astype(np.float32)
    vf = rng.standard_normal((h, b * max_ctx, hd)).astype(np.float32)
    q = rng.standard_normal((b, h * rep, hd)).astype(np.float32)
    (jk, tk), (jv, tv) = _pools(kf, kind), _pools(vf, kind)
    lens = np.asarray(lens, np.int32)
    ref = jkv.flash_contig_decode(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                  ctx_bucket, max_ctx, interpret=True)
    got = tkv.flash_contig_decode(torch.from_numpy(q), tk, tv,
                                  torch.from_numpy(lens), ctx_bucket, max_ctx)
    if kind == "f32":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-4, atol=2e-5)
    else:
        assert_close_max(got, _np(ref), 1e-2)


def _attention_inputs(kind, seed=7, b=2, h=2, rep=2, d=32, ps=8, pps=8):
    rng = np.random.RandomState(seed)
    P = b * pps
    kf = rng.standard_normal((h, P, ps, d)).astype(np.float32)
    vf = rng.standard_normal((h, P, ps, d)).astype(np.float32)
    q = rng.standard_normal((b, h * rep, d)).astype(np.float32)
    table = np.arange(P, dtype=np.int32).reshape(b, pps)[:, :4]
    lens = np.asarray([30, 11], np.int32)
    return (q, _pools(kf, kind), _pools(vf, kind), lens, table)


GEMMA_OPTS = dict(scale=0.25, softcap=50.0, window=8)


@pytest.mark.parametrize("fn", ["paged_attention", "contig_attention",
                                "_dense_paged_attention", "contig_dense"])
@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("opts", [{}, GEMMA_OPTS], ids=["plain", "gemma2"])
def test_attention_routes_match_jax(fn, kind, opts):
    """The routes the engine takes on the CPU (unquantized pools to the
    flash plain version, int8 pools and gemma2 options to the dense path),
    and the dense paths themselves, against the JAX package's."""
    q, (jk, tk), (jv, tv), lens, table = _attention_inputs(kind)
    args_j = (jnp.asarray(q), jk, jv, jnp.asarray(lens), jnp.asarray(table))
    args_t = (torch.from_numpy(q), tk, tv, torch.from_numpy(lens),
              torch.from_numpy(table))
    if fn == "contig_dense":
        ref = jkv.contig_attention(*args_j, impl="dense", **opts)
        got = tkv.contig_attention(*args_t, impl="dense", **opts)
    else:
        ref = getattr(jkv, fn)(*args_j, **opts)
        got = getattr(tkv, fn)(*args_t, **opts)
    assert_close_max(got, _np(ref), 1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_dense_attend_matches_jax(quantized):
    rng = np.random.RandomState(11)
    h, b, rep, ctx, d = 2, 3, 2, 40, 16
    q = rng.standard_normal((b, h * rep, d)).astype(np.float32)
    lens = np.asarray([40, 3, 17], np.int32)
    if quantized:
        kc, ks = _q8(rng.standard_normal((h, b, ctx, d)).astype(np.float32))
        vc, vs = _q8(rng.standard_normal((h, b, ctx, d)).astype(np.float32))
        ref = jkv._dense_attend_q8(*(jnp.asarray(a) for a in
                                     (q, kc, ks, vc, vs, lens)))
        got = tkv._dense_attend_q8(*(torch.from_numpy(a) for a in
                                     (q, kc, ks, vc, vs, lens)))
    else:
        kv = [rng.standard_normal((h, b, ctx, d)).astype(np.float32)
              for _ in range(2)]
        ref = jkv._dense_attend(*(jnp.asarray(a) for a in (q, *kv, lens)))
        got = tkv._dense_attend(*(torch.from_numpy(a) for a in (q, *kv, lens)))
    assert_close_max(got, _np(ref), 1e-5)


def _write_case(path, rng):
    """(kv [b, t, h, d], page_ids [b, t], offsets [b, t]) with distinct
    targets: a decode step of 3 slots, or a 10-token prefill."""
    h, d, ps = 2, 8, 8
    if path == "decode":
        kv = rng.standard_normal((3, 1, h, d)).astype(np.float32)
        page_ids = np.asarray([[2], [5], [0]], np.int32)
        offsets = np.asarray([[3], [0], [7]], np.int32)
    else:
        kv = rng.standard_normal((1, 10, h, d)).astype(np.float32)
        pos = np.arange(10)
        page_ids = np.asarray([4, 1])[pos // ps][None].astype(np.int32)
        offsets = (pos % ps)[None].astype(np.int32)
    return kv, page_ids, offsets


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("path", ["decode", "prefill"])
def test_write_tokens_bit_equal(path, kind):
    rng = np.random.RandomState(3)
    kv, page_ids, offsets = _write_case(path, rng)
    base = rng.standard_normal((2, 6, 8, 8)).astype(np.float32)
    jp, tp = _pools(base, kind)
    jp = jkv.write_tokens(jp, jnp.asarray(kv), jnp.asarray(page_ids),
                          jnp.asarray(offsets))
    assert tkv.write_tokens(tp, torch.from_numpy(kv),
                            torch.from_numpy(page_ids),
                            torch.from_numpy(offsets)) is None   # in place
    pairs = zip(jp, tp) if kind == "int8" else [(jp, tp)]
    for j, t in pairs:
        if t.dtype == torch.bfloat16:
            t, j = t.view(torch.int16), jnp.asarray(j).view(jnp.int16)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_int8_codes_saturate_like_xla():
    """The element equal to +amax rounds to 128: XLA's conversion saturates
    it to 127, a plain torch cast would wrap it to -128."""
    x = np.asarray([[[[1.0, -1.0, 0.5, 0.3]]]], np.float32)   # [b, t, h, d]
    jp = (jnp.zeros((1, 1, 1, 4), jnp.int8), jnp.ones((1, 1, 1), jnp.float32))
    tp = (torch.zeros((1, 1, 1, 4), dtype=torch.int8),
          torch.ones((1, 1, 1), dtype=torch.float32))
    ids = np.zeros((1, 1), np.int32)
    jp = jkv.write_tokens(jp, jnp.asarray(x), jnp.asarray(ids),
                          jnp.asarray(ids))
    tkv.write_tokens(tp, torch.from_numpy(x), torch.from_numpy(ids),
                     torch.from_numpy(ids))
    assert tp[0].flatten().tolist() == [127, -128, 64, 38]
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
    np.testing.assert_array_equal(tp[1].numpy(), np.asarray(jp[1]))
    naive = torch.round(torch.from_numpy(x) * (127.5 / 1.0)).to(torch.int8)
    assert naive.flatten()[0] == -128      # what the clamp prevents


def test_int8_round_trip_uses_127_5():
    """Dequant is code * amax / 127.5 (a plain code * amax was a 127.5x
    bug of the TPU kernels): a written and gathered context comes back
    within amax/255 of the input, equal to the JAX package's."""
    rng = np.random.RandomState(0)
    kv = rng.standard_normal((1, 10, 2, 4)).astype(np.float32)
    pos = np.arange(10)
    table = np.asarray([2, 3, 0, 0], np.int32)
    page_ids = table[pos // 8][None]
    offsets = (pos % 8)[None].astype(np.int32)
    jp = (jnp.zeros((2, 4, 8, 4), jnp.int8), jnp.ones((2, 4, 8), jnp.float32))
    tp = (torch.zeros((2, 4, 8, 4), dtype=torch.int8),
          torch.ones((2, 4, 8), dtype=torch.float32))
    jp = jkv.write_tokens(jp, jnp.asarray(kv), jnp.asarray(page_ids),
                          jnp.asarray(offsets))
    tkv.write_tokens(tp, torch.from_numpy(kv), torch.from_numpy(page_ids),
                     torch.from_numpy(offsets))
    got = tkv.gather_ctx(tp, torch.from_numpy(table)[None])[0, :10].numpy()
    ref = np.asarray(jkv.gather_ctx(jp, jnp.asarray(table)[None])[0, :10])
    np.testing.assert_array_equal(got, ref)
    amax = np.abs(kv[0]).max(-1, keepdims=True)
    # half a step, amax/255, plus float rounding of the dequant
    assert np.all(np.abs(got - kv[0]) <= amax * (1 / 255 + 1e-6))


@pytest.mark.parametrize("contiguous", [False, True])
def test_page_allocator_matches_jax(contiguous):
    args = (4 * 8, 4, 8) if contiguous else (12, 3, 4)
    ja, ta = jkv.PageAllocator(*args, contiguous), tkv.PageAllocator(
        *args, contiguous)
    ops = [("ensure", 0, 17), ("ensure", 1, 33), ("ensure", 2, 64),
           ("ensure", 0, 40), ("release", 1), ("ensure", 2, 9),
           ("ensure", 1, 5), ("release", 0), ("ensure", 0, 65),
           ("release", 2), ("ensure", 3 if contiguous else 2, 20)]
    for op in ops:
        if op[0] == "ensure":
            assert ja.ensure(op[1], op[2], 8) == ta.ensure(op[1], op[2], 8)
        else:
            ja.release(op[1])
            ta.release(op[1])
        np.testing.assert_array_equal(ta.table, ja.table)
        assert (ta.free, ta.version) == (ja.free, ja.version)
        assert ta.seq_pages == [list(p) for p in ja.seq_pages]


def test_create_pools():
    from any4_tpu_torch.models import llama
    cfg = llama.LlamaConfig.tiny()
    c = tkv.PagedKVCache.create(cfg, 5, 8, device="cpu")
    assert c.k_pages[0].shape == (2, 5, 8, 16)
    assert c.k_pages[0].dtype == torch.bfloat16 and not c.quantized
    q = tkv.PagedKVCache.create(cfg, 5, 8, quantize=True, device="cpu")
    codes, scales = q.v_pages[1]
    assert codes.dtype == torch.int8 and scales.shape == (2, 5, 8)
    assert bool((scales == 1).all()) and q.quantized


def test_flash_wrappers_validate():
    q = torch.zeros((1, 4, 12))
    pool = torch.zeros((2, 3, 8, 12))
    lens = torch.ones(1, dtype=torch.int32)
    table = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        tkv.flash_paged_decode(q, pool, pool, lens, table)
    meta = torch.zeros((1, 4, 16), device="meta")
    mpool = torch.zeros((2, 3, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tkv.flash_paged_decode(meta, mpool, mpool, lens, table)
    with pytest.raises(ValueError, match="does not hold"):
        tkv.flash_contig_decode(torch.zeros((2, 4, 16)),
                                torch.zeros((2, 24, 16)),
                                torch.zeros((2, 24, 16)),
                                torch.ones(2, dtype=torch.int32), 8, 16)
    with pytest.raises(ValueError, match="impl"):
        tkv.paged_attention(torch.zeros((1, 4, 16)), torch.zeros(
            (2, 3, 8, 16)), torch.zeros((2, 3, 8, 16)), lens, table,
            impl="upstream")
