"""The port's numeric core, packing and any4 learner against the JAX package.

Inputs are made with numpy from a seed and fed to both packages, on the CPU.
Bars:
- elementwise quantization math (group normalization, dequantization,
  nearest-codebook assignment) is bit-exact in float32: both sides do the
  same IEEE subtract/multiply/divide/compare, one op at a time;
- deterministic k-means inits (int, pow, nf4): LUT within 1e-4 and codes
  equal on at least 99.9% of entries (sums run in another order);
- k-means++ draws other random numbers than jax.random: weighted W-MSE
  within 1% of JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.ops import packing as jpacking
from any4_tpu.ops import quant as jquant
from any4_tpu.quant import anyq as janyq
from any4_tpu.quant import kmeans as jkmeans
from any4_tpu_torch.ops import packing, quant
from any4_tpu_torch.quant import anyq, kmeans


def _w(n, k, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("g", [32, 128])
def test_group_codes_float_bit_exact(symmetric, g):
    w = _w(24, 512)
    ref = jquant.group_codes_float(jnp.asarray(w), 4, g, symmetric=symmetric)
    out = quant.group_codes_float(torch.from_numpy(w), 4, g,
                                  symmetric=symmetric)
    for a, b in zip(out, ref):
        _eq(a, b)


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("per_row", [True, False])
def test_anyq_dequantize_bit_exact(centered, per_row):
    rng = np.random.default_rng(1)
    n, k, g = 16, 256, 64
    codes = rng.integers(0, 16, (n, k)).astype(np.uint8)
    lut = rng.uniform(0, 15, (n, 16) if per_row else (16,)).astype(np.float32)
    scales = rng.uniform(0.01, 1, (n, k // g)).astype(np.float32)
    zeros = rng.standard_normal((n, k // g)).astype(np.float32)
    ref = jquant.anyq_dequantize(*map(jnp.asarray, (codes, lut, scales,
                                                    zeros)),
                                 group_size=g, centered=centered)
    out = quant.anyq_dequantize(*map(torch.from_numpy, (codes, lut, scales,
                                                        zeros)),
                                group_size=g, centered=centered)
    _eq(out, ref)


@pytest.mark.parametrize("fmt", ["nf4", "fp4"])
def test_lut_quantize_bit_exact(fmt):
    w = _w(32, 512, seed=2)
    w[0, :4] = 0.0      # exact zeros and ties go to the lower code
    codes, scales = quant.lut_quantize(torch.from_numpy(w), fmt, 128)
    rc, rs = jquant.lut_quantize(jnp.asarray(w), fmt, 128)
    _eq(codes, rc)
    _eq(scales, rs)


@pytest.mark.parametrize("k", [1000, 1024, 1536, 2048])
def test_tpu_unpackers_match_jax(k):
    codes = np.random.default_rng(k).integers(0, 16, (40, k)).astype(np.uint8)
    row = np.asarray(jpacking.pack_int4(jnp.asarray(codes)))
    tr = np.asarray(jpacking.pack_int4_transposed(jnp.asarray(codes)))
    _eq(packing.unpack_int4(row, k), codes)
    _eq(packing.unpack_int4_transposed(tr, k), codes)
    _eq(packing.unpack_int4(row, k),
        jpacking.unpack_int4(jnp.asarray(row), k))
    _eq(packing.unpack_int4_transposed(tr, k),
        jpacking.unpack_int4_transposed(jnp.asarray(tr), k))
    _eq(packing.pack_int4(codes), row)
    _eq(packing.pack_int4_transposed(codes), tr)


@pytest.mark.parametrize("k", [64, 1000, 2048])
def test_hopper_pack_round_trip(k):
    codes = torch.from_numpy(
        np.random.default_rng(k).integers(0, 16, (12, k)).astype(np.uint8))
    packed = packing.pack_codes(codes)
    assert packed.dtype == torch.int32
    assert packed.shape == (12, packing.padded_k(k) // 8)
    _eq(packing.unpack_codes(packed, k), codes)
    # nibble j of word w is k = 8w + j; the padding is code 0
    full = packing.unpack_codes(packed, packing.padded_k(k))
    assert int(full[:, k:].abs().sum()) == 0
    w0 = int(packed[3, 0]) & 0xFFFFFFFF
    assert [(w0 >> (4 * j)) & 0xF for j in range(8)] == \
        codes[3, :8].tolist()


def _kmeans_pair(x, init, iters=8, sw=None):
    ref = jkmeans.kmeans_rows(jnp.asarray(x), 16, sample_weight=None if sw is
                              None else jnp.asarray(sw), init=init,
                              iters=iters)
    out = kmeans.kmeans_rows(torch.from_numpy(x), 16, sample_weight=None if
                             sw is None else torch.from_numpy(sw), init=init,
                             iters=iters)
    return out, ref


def _wmse(x, lut, codes, sw=None):
    recon = np.take_along_axis(np.asarray(lut), np.asarray(codes).astype(
        np.int64), axis=1)
    w = 1.0 if sw is None else sw
    return float(np.mean(w * (x - recon) ** 2))


@pytest.mark.parametrize("init", ["int", "pow", "nf4"])
def test_kmeans_deterministic_inits(init):
    x, _, _ = jquant.group_codes_float(jnp.asarray(_w(64, 512, seed=3)))
    x = np.array(x)
    (lut, codes), (rlut, rcodes) = _kmeans_pair(x, init)
    np.testing.assert_allclose(lut.numpy(), np.asarray(rlut), atol=1e-4,
                               rtol=0)
    assert (codes.numpy() == np.asarray(rcodes)).mean() >= 0.999
    assert torch.all(lut[:, 1:] >= lut[:, :-1])


@pytest.mark.parametrize("weighted", [False, True])
def test_kmeanspp_wmse_within_1pct(weighted):
    x, _, _ = jquant.group_codes_float(jnp.asarray(_w(128, 2048, seed=4)))
    x = np.array(x)
    sw = np.random.default_rng(5).uniform(0.1, 2, (2048,)).astype(
        np.float32) if weighted else None
    (lut, codes), (rlut, rcodes) = _kmeans_pair(x, "k-means++", iters=30,
                                                sw=sw)
    assert _wmse(x, lut, codes, sw) <= _wmse(x, rlut, rcodes, sw) * 1.01


def test_kmeans_row_chunks_and_restarts():
    x = np.array(jquant.group_codes_float(jnp.asarray(_w(40, 256)))[0])
    xt = torch.from_numpy(x)
    whole = kmeans.kmeans_rows(xt, init="int", iters=5)
    chunked = kmeans.kmeans_rows(xt, init="int", iters=5, row_chunk=7)
    _eq(whole[1], chunked[1])
    one = kmeans.kmeans_rows(xt, iters=5, generator=torch.Generator()
                             .manual_seed(3))
    three = kmeans.kmeans_rows(xt, iters=5, n_init=3,
                               generator=torch.Generator().manual_seed(3))
    assert _wmse(x, *three) <= _wmse(x, *one) * (1 + 1e-6)


def _recon_wmse(w, q):
    codes, lut, scales, zeros = (np.asarray(a) for a in q)
    lut = lut if lut.shape[0] == codes.shape[0] else np.broadcast_to(
        lut, (codes.shape[0], 16))
    recon = np.asarray(jquant.anyq_dequantize(
        jnp.asarray(codes), jnp.asarray(lut), jnp.asarray(scales),
        jnp.asarray(zeros)))
    return float(np.mean((w - recon) ** 2))


@pytest.mark.parametrize("kw", [
    dict(init="nf4"),
    dict(init="int", scale_sample_weight=True),
    dict(init="int", keep_outliers=True),
    dict(init="pow", per_row=False),
])
def test_any4_quantize_deterministic(kw):
    w = _w(32, 512, seed=6)
    ref = janyq.any4_quantize(jnp.asarray(w), kmeans_iters=6, **kw)
    out = anyq.any4_quantize(torch.from_numpy(w), kmeans_iters=6, **kw)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-4,
                               rtol=0)
    assert (out[0].numpy() == np.asarray(ref[0])).mean() >= 0.999
    _eq(out[2], ref[2])
    _eq(out[3], ref[3])


@pytest.mark.parametrize("kw", [
    dict(scale_sample_weight=True),
    dict(keep_outliers=True),
    dict(sample_weight=np.linspace(0.5, 2, 2048, dtype=np.float32),
         bias_pow=2.0),
])
def test_any4_quantize_kmeanspp_wmse(kw):
    w = _w(128, 2048, seed=7)
    ref = janyq.any4_quantize(jnp.asarray(w), kmeans_iters=30, **kw)
    out = anyq.any4_quantize(torch.from_numpy(w), kmeans_iters=30, **kw)
    assert _recon_wmse(w, out) <= _recon_wmse(w, ref) * 1.01
