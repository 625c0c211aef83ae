"""The decode-attention kernels' split context (flash-decoding), through
their plain versions on the CPU, with inputs made by numpy from a seed.

Bars:
- split against one split (``S >= ctx``): within 1e-6 * max|ref| where both
  compute in f32 throughout (paged kernels, contiguous f32 pools); within
  1e-2 * max|ref| for contiguous bf16 and int8 pools, whose probabilities
  are rounded to bf16 against the running max of their own split;
- two buckets over the same pools and lengths: bit-equal;
- every slot within one split: bit-equal to one split over the bucket (the
  kernels' direct write, with no ticket);
- a slot of length 0: exact zeros;
- paged against the interpreted JAX kernel at a context longer than S: the
  bars of ``test_torch_kv_cache.py``.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.serving import kv_cache as jkv
from any4_tpu_torch.serving import kv_cache as tkv
from test_torch_convert import assert_close_max
from test_torch_kv_cache import _np, _pools

KINDS = ["f32", "bf16", "int8"]


def _case(layout, kind, lens, bucket, h=2, rep=2, d=32, ps=16, max_ctx=512,
          seed=5):
    """(plain function, its arguments) over one set of pools: ``bucket``
    context tokens (paged: the first ``bucket / ps`` columns of a shuffled
    table; contig: ``ctx_bucket``)."""
    rng = np.random.RandomState(seed)
    b = len(lens)
    q = torch.from_numpy(rng.standard_normal((b, h * rep, d)).astype(
        np.float32))
    seq = torch.tensor(lens, dtype=torch.int32)
    if layout == "paged":
        pps = max_ctx // ps
        P = b * pps + 1
        shape = (h, P, ps, d)
    else:
        shape = (h, b * max_ctx, d)
    k = _pools(rng.standard_normal(shape).astype(np.float32), kind)[1]
    v = _pools(rng.standard_normal(shape).astype(np.float32), kind)[1]
    if layout == "paged":
        table = torch.from_numpy((rng.permutation(P - 1)[:b * pps] + 1)
                                 .reshape(b, pps).astype(np.int32))
        return tkv.flash_paged_decode_plain, (
            q, k, v, seq, table[:, :bucket // ps].contiguous())
    return tkv.flash_contig_decode_plain, (q, k, v, seq, bucket, max_ctx)


def _bar(layout, kind):
    return 1e-2 if layout == "contig" and kind != "f32" else 1e-6


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ["paged", "contig"])
def test_split_matches_one_split(layout, kind):
    fn, args = _case(layout, kind, [300, 75, 512], 512)
    S = tkv.split_len(3, 2)
    assert S < 300                      # several splits per slot
    got = fn(*args)
    ref = fn(*args, split=512)          # S >= ctx: one softmax
    assert got.shape == args[0].shape and got.dtype == args[0].dtype
    assert_close_max(got, ref.numpy(), _bar(layout, kind))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ["paged", "contig"])
@pytest.mark.parametrize("lens,buckets", [
    ([130, 200], (256, 512)),           # several live splits in both
    ([40, 64], (64, 256)),              # one split against four
], ids=["multi", "single"])
def test_buckets_bit_equal(layout, kind, lens, buckets):
    outs = [fn(*args) for fn, args in
            (_case(layout, kind, lens, bk) for bk in buckets)]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ["paged", "contig"])
def test_split_edge_lengths(layout, kind):
    S = tkv.split_len(4, 2)
    fn, args = _case(layout, kind, [S - 1, S, S + 1, 0], 256)
    got = fn(*args)
    assert_close_max(got, fn(*args, split=256).numpy(), _bar(layout, kind))
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("b,h", [(1, 8), (8, 8), (4, 8), (2, 2), (33, 8),
                                 (64, 16)])
def test_split_len_rule(b, h):
    assert list(inspect.signature(tkv.split_len).parameters) == ["b", "h"]
    S = tkv.split_len(b, h)
    assert S % 64 == 0 and 64 <= S <= 2048
    assert S == tkv.split_len(b, h)

    def blocks(s):
        return b * h * -(-2048 // s)
    # the largest such S: enough blocks at S (or S is the smallest), too
    # few at 2S (or S is the largest)
    assert S == 64 or blocks(S) >= tkv._SPLIT_MIN_BLOCKS
    assert S == 2048 or blocks(2 * S) < tkv._SPLIT_MIN_BLOCKS
    assert {(1, 8): 64, (8, 8): 512}.get((b, h), S) == S


@pytest.mark.parametrize("kind", KINDS)
def test_paged_long_context_matches_jax(kind):
    h, ps, hd, b, nq = 2, 8, 32, 2, 4
    pps = 24
    P = b * pps + 1
    rng = np.random.RandomState(12)
    kp = rng.randn(h, P, ps, hd).astype(np.float32)
    vp = rng.randn(h, P, ps, hd).astype(np.float32)
    q = rng.randn(b, nq, hd).astype(np.float32)
    table = (rng.permutation(P - 1)[:b * pps] + 1).reshape(b, pps).astype(
        np.int32)
    lens = np.asarray([150, 190], np.int32)
    assert lens.min() > 2 * tkv.split_len(b, h)
    (jk, tk), (jv, tv) = _pools(kp, kind), _pools(vp, kind)
    ref = jkv.flash_paged_decode(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                 jnp.asarray(table), interpret=True)
    got = tkv.flash_paged_decode(torch.from_numpy(q), tk, tv,
                                 torch.from_numpy(lens),
                                 torch.from_numpy(table))
    if kind == "int8":
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ["paged", "contig"])
def test_one_live_split_is_bit_equal_to_one_split(layout, kind):
    S = tkv.split_len(4, 2)
    fn, args = _case(layout, kind, [S, 1, S - 5, 0], 4 * S)
    assert torch.equal(fn(*args), fn(*args, split=4 * S))


def test_ticket_counters_are_zeroed_once_per_stream():
    """The kernels' tickets need zeros that they leave at zero: one buffer
    per device and stream, kept while it is large enough."""
    dev = torch.device("cpu")
    first = tkv._counters(dev, 7, 6)
    assert first.dtype == torch.int32 and bool((first == 0).all())
    assert tkv._counters(dev, 7, 4) is first
    bigger = tkv._counters(dev, 7, 64)
    assert bigger.numel() >= 64 and bool((bigger == 0).all())
    assert tkv._counters(dev, 8, 4) is not bigger
    tkv._COUNTERS.clear()
