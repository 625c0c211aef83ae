"""The last formats of the JAX package in the port, on the CPU: the MX
element library (``ops/mx.py``), the mx4 quantizers, ``int8p``, the
row-scale int8 formats (``int8r``, ``w8a8r``, ``any4q8r``), quantized
embedding lookups and the small leftovers of ``ops/quant.py`` and
``ops/packing.py``, each against the JAX package on the same numpy inputs.

Bars:
- the MX library and the mx4 quantizers: bit-equal, NaN bytes included,
  over every element format and rounding mode of
  ``tests/test_reference_parity.py``'s MX cases, on values at, just under
  and just over powers of two and with a NaN;
- ``quantize_tensor`` of the five formats: the fields JAX's carry across
  to, bit for bit (int8p's zeros within an ulp of ``120 s``: the JAX
  package keeps ``z - 120 s``), ``dequantize_tensor`` bit-equal (int8p
  within 1e-6 * max); any4q8r from the deterministic init at the any4q8
  tests' bar;
- ``linear`` through the plain versions (no launch counter moves) against
  JAX's ``linear`` (its Pallas kernels interpreted): ``int8r`` within 1e-4
  * max, ``w8a8r``/``any4q8r`` within 1e-5, ``int8p`` and ``mx4`` within
  1e-4 on float32 outputs; bf16 outputs within 2e-2;
- ``embedding_lookup``: bit-equal for every name of ``EMBED_FMTS``, and
  the names JAX refuses are refused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.ops import linear as jlin
from any4_tpu.ops import mx as jmx
from any4_tpu.ops import packing as jpack
from any4_tpu.ops import quant as jquant
from any4_tpu.quant import api as japi
from any4_tpu_torch import convert
from any4_tpu_torch.ops import gemv, linear as tlin, mx, packing, quant
from any4_tpu_torch.quant import api
from test_torch_convert import assert_close_max, jax_to_numpy

MX_FMTS = ("int8", "int4", "int2", "fp8_e4m3", "fp8_e5m2", "fp6_e3m2",
           "fp6_e2m3", "fp4")
NEW_FMTS = ("mx4", "int8p", "int8r", "w8a8r", "any4q8r")
ANY4 = dict(init="int", kmeans_iters=3)


def _w(n, k, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _near_powers_of_two(shape, seed, lo=-20, hi=20):
    """Signed values at, up to 3 ulps under and over ``2^e``, e in
    ``[lo, hi)``."""
    rng = np.random.default_rng(seed)
    e = rng.integers(lo, hi, shape)
    bits = np.ldexp(np.ones(shape), e).astype(np.float32).view(np.int32)
    v = (bits + rng.integers(-3, 4, shape)).astype(np.int32).view(np.float32)
    return v * np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _mx_input():
    a = np.concatenate([_w(8, 96, seed=11) * 3,
                        _near_powers_of_two((8, 96), 1)])
    a[3, 5] = np.nan
    a[4, 40] = -0.0
    return a


def _same_bits(got, want):
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("scale_rounding", ["even", "floor", "ceil"])
@pytest.mark.parametrize("rnd", ["nearest", "even", "floor"])
@pytest.mark.parametrize("fmt", MX_FMTS)
def test_quantize_mx_bit_equal(fmt, rnd, scale_rounding):
    a = _mx_input()
    want = jmx.quantize_mx(jnp.asarray(a), fmt, block_size=32, round=rnd,
                           block_scale_rounding_mode=scale_rounding)
    got = mx.quantize_mx(torch.from_numpy(a), fmt, block_size=32, round=rnd,
                         block_scale_rounding_mode=scale_rounding)
    _same_bits(got.numpy(), want)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "bfloat16", "fp16", "fp6_e2m3"])
def test_quantize_elemwise_and_float_bit_equal(fmt):
    a = np.concatenate([_w(4, 64, seed=12) * 100,
                        _near_powers_of_two((4, 64), 2, -12, 12)])
    a[0, 0] = np.inf
    eb, mb, _, mn, _ = jmx.format_params(fmt)
    assert mx.format_params(fmt) == jmx.format_params(fmt)
    _same_bits(mx.quantize_elemwise(torch.from_numpy(a), mb, eb, mn,
                                    round="even").numpy(),
               jmx.quantize_elemwise(jnp.asarray(a), mb, eb, mn,
                                     round="even"))
    _same_bits(mx.quantize_float(torch.from_numpy(a), fmt,
                                 allow_denorm=False).numpy(),
               jmx.quantize_float(jnp.asarray(a), fmt, allow_denorm=False))


def test_shared_exponents_and_padding_bit_equal():
    a = np.concatenate([_w(4, 64, seed=13), _near_powers_of_two((4, 64), 3)])
    for mode in ("even", "floor", "ceil"):
        for ebits in (0, 8):
            _same_bits(mx.shared_exponents(
                torch.from_numpy(a), axes=[-1], rounding_mode=mode,
                ebits=ebits).numpy(), jmx.shared_exponents(
                jnp.asarray(a), axes=[-1], rounding_mode=mode, ebits=ebits))
    b = _w(3, 50, seed=14)              # 50 is not a multiple of the block
    for axis in (-1, 0):
        _same_bits(mx.quantize_mx(torch.from_numpy(b), "fp4", block_size=32,
                                  axis=axis, flush_fp32_subnorms=True)
                   .numpy(),
                   jmx.quantize_mx(jnp.asarray(b), "fp4", block_size=32,
                                   axis=axis, flush_fp32_subnorms=True))
    with pytest.raises(ValueError, match="unknown mx element format"):
        mx.format_params("fp3")


def test_log2_exp2_follow_xla():
    """floor(log2) and exp2 as the JAX package gets them on the CPU, where
    XLA's differ from ``torch.log2``/``torch.exp2`` near powers of two."""
    v = np.concatenate([np.abs(_near_powers_of_two((64, 64), s, -60, 60))
                        for s in range(4)])
    want = np.asarray(jnp.floor(jnp.log2(jnp.asarray(v))))
    np.testing.assert_array_equal(
        torch.floor(quant.log2(torch.from_numpy(v))).numpy(), want)
    e = np.arange(-127, 128).astype(np.float32)
    _same_bits(quant.exp2(torch.from_numpy(e)).numpy(),
               jnp.exp2(jnp.asarray(e)))


@pytest.mark.parametrize("g", [32, 64])
def test_mx4_quantizers_bit_equal(g):
    w = np.concatenate([_w(16, 256, seed=2), _near_powers_of_two(
        (16, 256), 3) * 0.1])
    w[1, 3] = np.nan                     # a NaN group
    w[2, :g] = 0.0                       # an all-zero group
    w[5, 0] = np.inf                     # exponent over 127: the NaN byte
    w[8, :g] = 3e38                      # the largest exponent, 125
    w[6, :g] *= 1e-39                    # below the smallest normal
    codes, exps = jquant.mx4_quantize(jnp.asarray(w), g)
    tc, te = quant.mx4_quantize(torch.from_numpy(w), g)
    _same_bits(tc.numpy(), codes)
    _same_bits(te.numpy(), exps)
    assert int(te[1, 0]) == int(te[5, 0]) == quant.E8M0_NAN
    _same_bits(quant.mx4_scales(te).numpy(), jquant.mx4_scales(exps))
    _same_bits(quant.mx4_dequantize(tc, te, g).numpy(),
               jquant.mx4_dequantize(codes, exps, g))


def test_small_leftovers_equal_jax():
    w = _w(24, 256, seed=4)
    codes, scales = jquant.lut_quantize(jnp.asarray(w), "nf4", 64)
    _same_bits(quant.lut_dequantize(torch.from_numpy(np.array(codes)),
                                    torch.from_numpy(np.array(scales)),
                                    "nf4", 64).numpy(),
               jquant.lut_dequantize(codes, scales, "nf4", 64))
    s, z = _w(24, 4, seed=5), _w(24, 4, seed=6)
    sz = quant.pack_scales_and_zeros(torch.from_numpy(s), torch.from_numpy(z))
    _same_bits(sz.numpy(), jquant.pack_scales_and_zeros(jnp.asarray(s),
                                                        jnp.asarray(z)))
    back = quant.unpack_scales_and_zeros(sz)
    _same_bits(back[0].numpy(), s)
    _same_bits(back[1].numpy(), z)
    ps, pz = packing.pad_group_arrays(torch.from_numpy(s),
                                      torch.from_numpy(z), 500, 128)
    js, jz = jpack.pad_group_arrays(jnp.asarray(s), jnp.asarray(z), 500, 128)
    _same_bits(ps.numpy(), js)
    _same_bits(pz.numpy(), jz)
    _same_bits(packing.pad_axis(torch.from_numpy(s), 0, 30, 7.0).numpy(),
               jpack.pad_axis(jnp.asarray(s), 0, 30, 7.0))
    for fmt in ("any4", "nf4", "fp4", "mx4", "int4"):
        for g in (32, 128, 256):
            assert packing.transposed_layout(fmt, g) \
                == jpack.transposed_layout(fmt, g)


def test_new_tpu_layouts_equal_jax():
    q = np.random.default_rng(7).integers(-128, 128, (48, 384)).astype(
        np.int8)
    _same_bits(packing.pack_rowscale(q), jpack.pack_rowscale(jnp.asarray(q)))
    _same_bits(packing.unpack_rowscale(packing.pack_rowscale(q), 384), q)
    jqt = jlin.quantize_tensor(jnp.asarray(_w(48, 384, seed=8)), "int8p", 128)
    port = tlin.quantize_tensor(torch.from_numpy(_w(48, 384, seed=8)),
                                "int8p", 128)
    q8 = port.packed[:, :384].numpy()
    _same_bits(packing.pack_int8_planes(q8), jqt.packed)
    _same_bits(packing.unpack_int8_planes(np.asarray(jqt.packed), 384), q8)


def _mode_kw(fmt, mode):
    kw = dict(ANY4) if fmt == "any4q8r" else {}
    if mode == "symmetric":
        kw["scale_only"] = True
    elif mode == "int_zeros":
        kw["int_zeros"] = True
    return kw


FIELD_CASES = [(f, "asymmetric") for f in NEW_FMTS] + [
    ("int8p", "symmetric"), ("int8p", "int_zeros"), ("int8r", "symmetric"),
    ("w8a8r", "symmetric"), ("any4q8r", "symmetric")]


@pytest.mark.parametrize("fmt,mode", FIELD_CASES,
                         ids=[f"{f}-{m}" for f, m in FIELD_CASES])
def test_quantize_tensor_fields_equal_jax(fmt, mode):
    """The port's own ``quantize_tensor`` carried to the JAX package's
    fields equals JAX's, and JAX's carried into the port dequantizes as
    JAX's does (any4q8r: the learner's tolerance, as any4q8)."""
    g = 32 if fmt == "mx4" else 128
    n, k = 48, 1408 if fmt != "int8p" else 1536
    w = _w(n, k, seed=9) * 2.0
    kw = _mode_kw(fmt, mode)
    jqt = jlin.quantize_tensor(jnp.asarray(w), fmt, g, **kw)
    qt = tlin.quantize_tensor(torch.from_numpy(w), fmt, g, **kw)
    ref = convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")
    assert qt.fmt == ref.fmt == fmt
    assert qt.group_size == ref.group_size == (k if fmt.endswith("r") else g)
    back = convert.qt_to_jax(qt)
    want = jax_to_numpy(jqt)
    if fmt == "any4q8r":
        equal = float((qt.packed == ref.packed).float().mean())
        assert equal >= 0.999, equal
        np.testing.assert_allclose(qt.scales.numpy(), ref.scales.numpy(),
                                   rtol=1e-4, atol=0)
        _same_bits(qt.zeros.numpy(), ref.zeros.numpy())
    else:
        for f in convert.QT_FIELDS:
            if want[f] is None:
                assert back[f] is None
            else:
                _same_bits(back[f], want[f])
        for f in ("packed", "scales", "lut"):
            a, b = getattr(qt, f), getattr(ref, f)
            assert (a is None) == (b is None)
            if a is not None:
                _same_bits(a.numpy(), b.numpy())
        if fmt == "int8p":
            # z = (z - 120 s) + 120 s: within an ulp of 120 s
            ulp = np.spacing(np.float32(120.0) * np.abs(qt.scales.numpy()))
            assert (np.abs(qt.zeros.numpy() - ref.zeros.numpy())
                    <= ulp).all()
        else:
            _same_bits(qt.zeros.numpy(), ref.zeros.numpy())
    deq = np.asarray(jlin.dequantize_tensor(jqt, jnp.float32))
    got = tlin.dequantize_tensor(ref, torch.float32).numpy()
    if fmt == "int8p":
        assert_close_max(got, deq, 1e-6)
    else:
        _same_bits(got, deq)
    if fmt.endswith("r"):
        assert qt.scales.shape == qt.zeros.shape == (1, n)


def test_format_checks():
    w = torch.from_numpy(_w(16, 1024))
    with pytest.raises(ValueError, match="multiple of 128"):
        tlin.quantize_tensor(w, "int8p", 64)
    with pytest.raises(ValueError, match="k a multiple of 128"):
        tlin.quantize_tensor(w[:, :1000], "int8p", 128)
    with pytest.raises(ValueError, match="int_zeros"):
        tlin.quantize_tensor(w, "w8a8r", int_zeros=True)
    for fmt in ("mx4", "nf4"):
        with pytest.raises(ValueError, match="scale_only"):
            tlin.quantize_tensor(w, fmt, 32, scale_only=True)
    with pytest.raises(ValueError, match="unsupported fmt"):
        tlin.quantize_tensor(w, "int3")
    with pytest.raises(ValueError, match="unsupported fmt"):
        convert.qt_from_jax({"fmt": "int3", "packed": None}, device="cpu")
    assert all(f in tlin.FMTS for f in NEW_FMTS)
    assert set(api.quant_methods) == set(japi.quant_methods)
    assert api.quant_methods["mx4"].keywords["group_size"] == 32


def _spy_plains(monkeypatch):
    seen = []
    for name in dir(gemv):
        if name.endswith("_plain"):
            orig = getattr(gemv, name)
            monkeypatch.setattr(gemv, name, lambda x, *a, _o=orig, _n=name:
                                seen.append((_n, x.shape[0])) or _o(x, *a))
    return seen


# fmt -> (m, the plain version it runs, the float32 bar)
LINEAR_CASES = [
    ("int8r", 3, "int8_post_plain", 1e-4),
    ("int8r", 70, "int8_post_plain", 1e-4),
    ("w8a8r", 3, "w8a8_fused_plain", 1e-5),
    ("w8a8r", 70, "w8a8_plain", 1e-5),
    ("any4q8r", 5, "w8a8_fused_plain", 1e-5),
    ("any4q8r", 70, "w8a8_plain", 1e-5),
    ("int8p", 5, "int8_post_plain", 1e-4),
    ("mx4", 5, "q4_lut_fused_plain", 1e-4),
]


@pytest.mark.parametrize("fmt,m,plain,bar", LINEAR_CASES,
                         ids=[f"{c[0]}-m{c[1]}" for c in LINEAR_CASES])
def test_linear_matches_jax(fmt, m, plain, bar, monkeypatch):
    g = 32 if fmt == "mx4" else 128
    k = 1536 if fmt == "int8p" else 1408
    kw = dict(ANY4) if fmt == "any4q8r" else {}
    jqt = jlin.quantize_tensor(jnp.asarray(_w(64, k, seed=21)), fmt, g, **kw)
    qt = convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")
    x = _w(m, k, seed=22)
    before = dict(gemv.LAUNCHES)
    seen = _spy_plains(monkeypatch)
    y = tlin.linear(torch.from_numpy(x), qt)
    assert [s for s, _ in seen] == [plain] and gemv.LAUNCHES == before
    assert y.shape == (m, 64) and y.dtype == torch.float32
    ref = np.asarray(jlin.linear(jnp.asarray(x), jqt, interpret=True))
    assert_close_max(y, ref, bar)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = tlin.linear(xb, qt)
    assert yb.dtype == torch.bfloat16
    refb = jlin.linear(jnp.asarray(x, jnp.bfloat16), jqt, interpret=True)
    assert_close_max(yb, np.asarray(refb.astype(jnp.float32)), 2e-2)


def test_mx4_nan_group_poisons_its_row_only():
    """A group poisoned to NaN stores the NaN byte; kernel B's plain version
    gives NaN in that weight row's output and finite values elsewhere."""
    w = _w(40, 512, seed=23)
    w[7, 64:96] = np.nan
    qt = tlin.quantize_tensor(torch.from_numpy(w), "mx4", 32)
    y = tlin.linear(torch.from_numpy(_w(3, 512, seed=24)), qt)
    nan = torch.isnan(y)
    assert bool(nan[:, 7].all()) and not bool(nan[:, :7].any()) \
        and not bool(nan[:, 8:].any())


@pytest.mark.parametrize("fmt", jlin.EMBED_FMTS)
def test_embedding_lookup_bit_equal(fmt):
    g = {"mx4": 32, "w8a8": 128}.get(fmt, 64)
    kw = dict(ANY4) if fmt == "any4" else {}
    table = _w(96, 256, seed=25)
    jqt = jlin.quantize_tensor(jnp.asarray(table), fmt, g, layout="row", **kw)
    qt = convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")
    ids = np.array([[3, 95, 0], [3, 17, 60]], np.int32)
    want = jlin.embed(jqt, jnp.asarray(ids), jnp.float32)
    got = tlin.embed(qt, torch.from_numpy(ids), torch.float32)
    _same_bits(got.numpy(), want)
    assert tuple(tlin.EMBED_FMTS) == tuple(jlin.EMBED_FMTS)


@pytest.mark.parametrize("fmt", ["int4p", "w4a8", "int8p", "any4t", "int8q",
                                 "w8a8r"])
def test_embedding_lookup_refuses_what_jax_refuses(fmt):
    qt = tlin.quantize_tensor(torch.from_numpy(_w(64, 256, seed=26)), fmt,
                              128, **(ANY4 if fmt == "any4t" else {}))
    assert qt.fmt == fmt
    with pytest.raises(ValueError, match="row-gatherable"):
        tlin.embedding_lookup(qt, torch.zeros(2, dtype=torch.long))
