"""The int8-weight formats in the port against the JAX package (CPU):
``int8_quantize``, the TPU int8 layouts' numpy copies, ``quantize_tensor``'s
renames and checks, ``dequantize_tensor``, the plain versions of
``w8a8``/``w8a8_fused``/``int8_post``/``int8_fused``, and ``linear``'s routing.

The JAX side quantizes ``jnp`` arrays and runs its Pallas kernels in
interpret mode. Bars:

- ``int8_quantize`` (all three branches), the layouts, ``quantize_tensor``'s
  fields and ``dequantize_tensor``: bit-equal;
- plain ``w8a8`` and ``w8a8_fused`` within 1e-5 * max|ref| of JAX's kernels
  in f32 (their integer dots are exact; only the order of the f32 affine
  sums differs), plain ``int8_post`` and ``int8_fused`` within 1e-4 (f32
  sums in another order);
- the grouped formats through ``linear`` within 1e-5 (w8a8g) and 1e-4
  (int8g) of JAX's ``linear``; fused and external W8A8 within 1e-5 of each
  other; ``int8_fused`` on the identity weight bit-exact;
- any4q8 from a deterministic k-means init: the snapped codes at least
  99.9% equal to JAX's and the scales within 1e-4 relative; ``linear`` on
  the carried weight within 1e-5 of JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.ops import linear as jlin
from any4_tpu.ops import packing as jpack
from any4_tpu.ops import quant as jquant
from any4_tpu.ops.pallas import gemv as jgemv
from any4_tpu_torch import convert
from any4_tpu_torch.ops import gemv, linear as tlin, packing, quant
from test_torch_convert import assert_close_max, jax_to_numpy

QUANT_MODES = [(False, False), (True, False), (False, True)]
QUANT_IDS = ["asymmetric", "symmetric", "int_zeros"]
NAMES = ("int8", "int8q", "int8t", "int8g", "w8a8", "w8a8q", "w8a8t",
         "w8a8g", "any4q8", "any4q8g")
ANY4 = dict(init="int", kmeans_iters=3)


def _w(n, k, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _pair(fmt, n, k, g, seed=0, **kw):
    jqt = jlin.quantize_tensor(jnp.asarray(_w(n, k, seed)), fmt,
                               group_size=g, **kw)
    return jqt, convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")


@pytest.mark.parametrize("symmetric,int_zeros", QUANT_MODES, ids=QUANT_IDS)
@pytest.mark.parametrize("g", [128, 64])
def test_int8_quantize_bit_equal(symmetric, int_zeros, g):
    w = _w(130, 1408, seed=g) * 3.0
    w[3, :g] = 0.0                                  # a constant group
    ref = jquant.int8_quantize(jnp.asarray(w), g, symmetric=symmetric,
                               int_zeros=int_zeros)
    got = quant.int8_quantize(torch.from_numpy(w), g, symmetric=symmetric,
                              int_zeros=int_zeros)
    for a, b in zip(got, ref):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if not symmetric:
        assert int(got[0].min()) == -128            # codes reach -128
    np.testing.assert_array_equal(
        quant.int8_dequantize(*got, g).numpy(),
        np.asarray(jquant.int8_dequantize(*ref, g)))


@pytest.mark.parametrize("layout", ["", "_quad", "_transposed", "_grouped"])
def test_tpu_int8_layouts_equal_jax_and_round_trip(layout):
    q = np.random.default_rng(4).integers(-128, 128, (132, 1408)).astype(
        np.int8)
    pack = getattr(packing, f"pack_int8{layout}")
    words = pack(q)
    np.testing.assert_array_equal(
        words, np.asarray(getattr(jpack, f"pack_int8{layout}")(
            jnp.asarray(q))))
    back = getattr(packing, f"unpack_int8{layout}")(words, 1408)
    assert back.dtype == np.int8
    np.testing.assert_array_equal(back, q)
    if layout:
        np.testing.assert_array_equal(
            back, np.asarray(getattr(jpack, f"unpack_int8{layout}")(
                jnp.asarray(words), 1408)))
    if layout == "_quad":
        with pytest.raises(ValueError, match="n % 4"):
            pack(q[:130])


def test_int8_routing_is_k_dependent():
    """The renames of ``tests/kernels/test_gemv.py``'s routing test: the
    ``q`` names at k < 4096, the ``g`` names at k >= 4096 or odd n, the
    name kept with ``layout="row"`` or g < 128; every layout reconstructs
    the same weight."""
    w = torch.from_numpy(_w(64, 1024, seed=51))
    wl = torch.from_numpy(_w(64, 4096, seed=52) * 0.1)
    for fmt in ("int8", "w8a8"):
        qt = tlin.quantize_tensor(w, fmt, 128)
        assert qt.fmt == fmt + "q" and qt.packed.dtype == torch.int8
        qg = tlin.quantize_tensor(wl, fmt, 128)
        assert qg.fmt == fmt + "g" and qg.packed.shape == (64, 4096)
        qr = tlin.quantize_tensor(w, fmt, 128, layout="row")
        assert qr.fmt == fmt
        assert torch.equal(tlin.dequantize_tensor(qt, torch.float32),
                           tlin.dequantize_tensor(qr, torch.float32))
        qgq = tlin.quantize_tensor(wl, fmt + "q", 128)
        assert torch.equal(tlin.dequantize_tensor(qg, torch.float32),
                           tlin.dequantize_tensor(qgq, torch.float32))
    assert tlin.quantize_tensor(w[:63], "int8", 128).fmt == "int8g"
    assert tlin.quantize_tensor(w, "int8", 64).fmt == "int8"
    assert tlin.quantize_tensor(w, "any4q8", 128, **ANY4).fmt == "any4q8"
    assert tlin.quantize_tensor(wl, "any4q8", 128, **ANY4).fmt == "any4q8g"


def test_int8_format_checks():
    """The JAX package's checks: g % 128 for every name but int8/int8t/
    w8a8t, n % 4 for the quad names, and scale_only/int_zeros refused by
    the quad names (so by ``int8``/``w8a8`` at k < 4096 too)."""
    w = torch.from_numpy(_w(130, 1024))
    for fmt, n, g in (("w8a8q", 128, 64), ("int8q", 130, 128),
                      ("w8a8", 128, 64), ("int8g", 128, 64),
                      ("any4q8", 130, 128)):
        with pytest.raises(ValueError):
            tlin.quantize_tensor(w[:n], fmt, g, layout="row")
    for kw in (dict(scale_only=True), dict(int_zeros=True)):
        for fmt in ("int8", "w8a8q"):
            with pytest.raises(ValueError):
                tlin.quantize_tensor(w[:128], fmt, 128, **kw)
        for fmt, layout in (("int8", "row"), ("w8a8t", None),
                            ("int8g", None)):
            qt = tlin.quantize_tensor(w[:128], fmt, 128, layout=layout, **kw)
            assert qt.fmt == fmt
    with pytest.raises(ValueError, match="int_zeros"):
        tlin.quantize_tensor(w[:128], "any4q8", 128, int_zeros=True)


# (name, n, k, g, layout): quantize_tensor in both packages
QT_CASES = [("int8", 132, 1536, 128, "row"), ("int8", 132, 1536, 64, None),
            ("int8q", 132, 1536, 256, None), ("int8t", 130, 1408, 128, None),
            ("int8g", 130, 1536, 128, None), ("w8a8", 132, 1536, 128, "row"),
            ("w8a8q", 132, 1536, 128, None), ("w8a8t", 132, 1408, 64, None),
            ("w8a8g", 132, 4096, 128, None)]


@pytest.mark.parametrize("name,n,k,g,layout", QT_CASES,
                         ids=[f"{c[0]}-g{c[3]}" for c in QT_CASES])
@pytest.mark.parametrize("symmetric,int_zeros", QUANT_MODES, ids=QUANT_IDS)
def test_quantize_tensor_bit_equal(name, n, k, g, layout, symmetric,
                                   int_zeros):
    """The port's own quantization gives JAX's name, codes, scales and
    zeros; ``qt_to_jax`` gives JAX's packed array back."""
    kw = dict(scale_only=symmetric, int_zeros=int_zeros)
    if layout:
        kw["layout"] = layout
    w = _w(n, k, seed=7)
    if name in ("int8q", "w8a8q") and (symmetric or int_zeros):
        # the quad names take neither flag, in both packages
        with pytest.raises(AssertionError):
            jlin.quantize_tensor(jnp.asarray(w), name, group_size=g, **kw)
        with pytest.raises(ValueError):
            tlin.quantize_tensor(torch.from_numpy(w), name, g, **kw)
        return
    jqt = jlin.quantize_tensor(jnp.asarray(w), name, group_size=g, **kw)
    qt = tlin.quantize_tensor(torch.from_numpy(w), name, g, **kw)
    ref = convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")
    assert qt.fmt == jqt.fmt == name and qt.lut is None
    for f in ("packed", "scales", "zeros"):
        assert torch.equal(getattr(qt, f), getattr(ref, f)), f
    back = convert.qt_to_jax(qt)
    np.testing.assert_array_equal(back["packed"], np.asarray(jqt.packed))
    assert back["packed"].dtype == np.asarray(jqt.packed).dtype


@pytest.mark.parametrize("name", NAMES)
def test_dequantize_equals_jax(name):
    """Every int8 name, quantized by JAX and carried across: the port's
    ``dequantize_tensor`` equals JAX's bit for bit, and the weight goes back
    to JAX's fields unchanged."""
    k = 4096 if name.endswith("g") else 1536
    kw = dict(ANY4) if name.startswith("any4") else {}
    if name in ("int8", "w8a8", "any4q8"):
        kw["layout"] = "row"                        # no rename
    jqt, qt = _pair(name, 132, k, 128, seed=11, **kw)
    assert qt.fmt == name and qt.packed.shape == (132, packing.padded_k(k))
    np.testing.assert_array_equal(
        tlin.dequantize_tensor(qt, torch.float32).numpy(),
        np.asarray(jlin.dequantize_tensor(jqt, jnp.float32)))
    back = convert.qt_to_jax(qt)
    for f in convert.QT_FIELDS:
        ref = getattr(jqt, f)
        if ref is None:
            assert back[f] is None
        else:
            np.testing.assert_array_equal(back[f], np.asarray(ref))


def _jax_kernel(x, jqt):
    return np.asarray(jgemv.quantized_matmul(
        jnp.asarray(x), jqt.packed, jqt.scales, jqt.zeros, None,
        fmt=jlin._kernel_fmt(jqt.fmt), group_size=jqt.group_size,
        n=jqt.shape[0], interpret=True, out_dtype=jnp.float32))


def _port_kernel(x, qt):
    return gemv.quantized_matmul(
        torch.from_numpy(x), qt.packed, qt.scales, qt.zeros,
        group_size=qt.group_size, out_dtype=torch.float32,
        fmt=tlin._kernel_fmt(qt.fmt))


# (name, layout, g, the port kernel): each TPU kernel #11-19 in turn
KERNEL_CASES = [("w8a8", "row", 128, "w8a8"), ("w8a8q", None, 128, "w8a8"),
                ("w8a8t", None, 256, "w8a8"), ("int8q", None, 128,
                                               "int8_post"),
                ("int8t", None, 256, "int8_post"),
                ("int8", "row", 128, "int8_fused"),
                ("int8", None, 64, "int8_fused")]


@pytest.mark.parametrize("m", [1, 4, 80])
@pytest.mark.parametrize("name,layout,g,kernel", KERNEL_CASES,
                         ids=[f"{c[0]}-g{c[2]}" for c in KERNEL_CASES])
def test_plain_matches_jax_kernel(name, layout, g, kernel, m):
    """The W8A8 names with float x at m <= 64 (the fused kernels #12, #14,
    #16) and int8 x (#11, #13, #15: the f32 sum before ``* sx``); the
    weight-only names with float x (#17, #18, #19)."""
    kw = {"layout": layout} if layout else {}
    jqt, qt = _pair(name, 256, 2048, g, seed=m, **kw)
    assert qt.fmt == name
    x = _w(m, 2048, seed=m + 5)
    if name.startswith("w8a8"):
        xq = np.asarray(jlin.quantize_activations(jnp.asarray(x))[0])
        y = _port_kernel(xq, qt)
        assert_close_max(y, _jax_kernel(xq, jqt), 1e-5)
        if m <= gemv.FUSED_ACT_M_MAX:
            assert_close_max(_port_kernel(x, qt), _jax_kernel(x, jqt), 1e-5)
        return
    before = dict(gemv.LAUNCHES)
    y = _port_kernel(x, qt)
    assert gemv.LAUNCHES == before      # CPU tensors launch nothing
    assert y.shape == (m, 256) and y.dtype == torch.float32
    assert_close_max(y, _jax_kernel(x, jqt), 1e-4)
    ref = x @ np.asarray(jlin.dequantize_tensor(jqt, jnp.float32)).T
    assert_close_max(y, ref, 2e-2)


@pytest.mark.parametrize("m", [1, 80, 200])
@pytest.mark.parametrize("name", ["int8", "w8a8", "any4q8"])
def test_grouped_linear_matches_jax(name, m):
    """k = 4096 routes to the grouped formats: the kernel route up to 128
    rows, dequantize-then-matmul above (m = 200)."""
    kw = ANY4 if name == "any4q8" else {}
    jqt, qt = _pair(name, 64, 4096, 128, seed=54, **kw)
    assert qt.fmt == jqt.fmt == name + "g"
    x = _w(m, 4096, seed=55)
    ref = np.asarray(jlin.linear(jnp.asarray(x), jqt, interpret=True))
    y = tlin.linear(torch.from_numpy(x), qt)
    assert y.shape == (m, 64) and y.dtype == torch.float32
    assert_close_max(y, ref, 1e-4 if name == "int8" else 1e-5)


def test_int8_fused_identity_bit_exact():
    """W = I through ``int8_fused`` in bf16 gives x back exactly, as JAX's
    ``_int8_kernel`` does: each weight is exactly 0 or 1 after its bf16(q * s
    + z) rounding (``tests/kernels/test_gemv.py``'s identity test)."""
    k = 1024
    jqt = jlin.quantize_tensor(jnp.eye(k, dtype=jnp.float32), "int8",
                               group_size=128, layout="row")
    qt = convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")
    assert qt.fmt == "int8"
    x = np.asarray(jnp.asarray(_w(4, k, seed=5), jnp.bfloat16).astype(
        jnp.float32))
    y = gemv.quantized_matmul(torch.from_numpy(x).to(torch.bfloat16),
                              qt.packed, qt.scales, qt.zeros, group_size=128,
                              fmt="int8")
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(), x)
    ref = jgemv.quantized_matmul(
        jnp.asarray(x, jnp.bfloat16), jqt.packed, jqt.scales, jqt.zeros,
        None, fmt="int8", group_size=128, n=k, interpret=True,
        out_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("m", [1, 16, gemv.FUSED_ACT_M_MAX])
@pytest.mark.parametrize("name", ["w8a8q", "w8a8t"])
def test_fused_act_quant_matches_external(name, m):
    """Decode (float x, quantized inside) and prefill (int8 x from
    ``quantize_activations``) agree: same absmax, same rounding, same scale
    point (``tests/kernels/test_gemv.py``'s external-vs-fused check)."""
    _, qt = _pair(name, 128, 1024, 128, seed=54)
    x = torch.from_numpy(_w(m, 1024, seed=55 + m))
    fused = gemv.w8a8_fused(x, qt.packed, qt.scales, qt.zeros, 128,
                            torch.float32)
    xq, sx = quant.quantize_activations(x)
    ext = gemv.w8a8(xq, qt.packed, qt.scales, qt.zeros, 128) * sx
    assert_close_max(fused, ext.numpy(), 1e-5)


@pytest.mark.parametrize("per_row", [True, False])
def test_any4q8_matches_jax(per_row):
    """any4q8 from the deterministic ``int`` init: the port's LUT snap gives
    JAX's int8 codes (at least 99.9% equal) and scales (1e-4 relative), and
    ``linear`` on JAX's weight carried across equals JAX's within 1e-5."""
    kw = dict(ANY4, per_row=per_row)
    w = _w(128, 2048, seed=31)
    jqt = jlin.quantize_tensor(jnp.asarray(w), "any4q8", group_size=128,
                               **kw)
    qt = tlin.quantize_tensor(torch.from_numpy(w), "any4q8", 128, **kw)
    ref = convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")
    assert qt.fmt == ref.fmt == "any4q8" and qt.packed.dtype == torch.int8
    assert int(qt.packed.abs().max()) <= 127
    equal = float((qt.packed == ref.packed).float().mean())
    assert equal >= 0.999, equal
    np.testing.assert_allclose(qt.scales.numpy(), ref.scales.numpy(),
                               rtol=1e-4, atol=0)
    np.testing.assert_array_equal(qt.zeros.numpy(), ref.zeros.numpy())
    x = _w(3, 2048, seed=32)
    want = np.asarray(jlin.linear(jnp.asarray(x), jqt, interpret=True))
    assert_close_max(tlin.linear(torch.from_numpy(x), ref), want, 1e-5)
    assert_close_max(tlin.linear(torch.from_numpy(x), qt), want, 2e-2)


def _spy(monkeypatch, names):
    seen = []
    for name in names:
        orig = getattr(gemv, name)
        monkeypatch.setattr(gemv, name, lambda x, *a, _o=orig, _n=name:
                            seen.append((_n, x.shape[0])) or _o(x, *a))
    return seen


PLAINS = ("w8a8_plain", "w8a8_fused_plain", "int8_post_plain",
          "int8_fused_plain")
# (fmt, k, layout, g, m) -> the plain versions called, with their m
ROUTES = [
    ("int8", 1024, None, 128, 3, [("int8_post_plain", 3)]),
    ("int8", 1024, None, 128, 600, [("int8_post_plain", 512),
                                    ("int8_post_plain", 88)]),
    ("int8", 1024, "row", 128, 3, [("int8_fused_plain", 3)]),
    ("int8", 1024, None, 64, 3, [("int8_fused_plain", 3)]),
    ("int8t", 1024, None, 128, 3, [("int8_post_plain", 3)]),
    ("int8", 4096, None, 128, 128, [("int8_post_plain", 128)]),
    ("int8", 4096, None, 128, 129, []),
    ("w8a8", 1024, None, 128, 1, [("w8a8_fused_plain", 1)]),
    ("w8a8", 1024, None, 128, 64, [("w8a8_fused_plain", 64)]),
    ("w8a8", 1024, None, 128, 65, [("w8a8_plain", 65)]),
    ("w8a8", 1024, None, 128, 1100, [("w8a8_plain", 1024),
                                     ("w8a8_plain", 76)]),
    ("w8a8", 1024, "row", 128, 2, [("w8a8_fused_plain", 2)]),
    ("w8a8t", 1024, None, 128, 70, [("w8a8_plain", 70)]),
    ("w8a8", 4096, None, 128, 2, [("w8a8_plain", 2)]),
    ("w8a8", 4096, None, 128, 129, []),
    ("any4q8", 1024, None, 128, 2, [("w8a8_fused_plain", 2)]),
    ("any4q8", 4096, None, 128, 2, [("w8a8_plain", 2)]),
]


@pytest.mark.parametrize("fmt,k,layout,g,m,want", ROUTES,
                         ids=[f"{r[0]}-k{r[1]}-{r[2]}-g{r[3]}-m{r[4]}"
                              for r in ROUTES])
def test_linear_routes(fmt, k, layout, g, m, want, monkeypatch):
    kw = {"layout": layout} if layout else {}
    if fmt == "any4q8":
        kw.update(ANY4)
    qt = tlin.quantize_tensor(torch.from_numpy(_w(64, k)), fmt, g, **kw)
    seen = _spy(monkeypatch, PLAINS)
    y = tlin.linear(torch.from_numpy(_w(m, k, seed=1)), qt)
    assert seen == want and y.shape == (m, 64)


def test_wrappers_validate():
    _, qt = _pair("w8a8q", 128, 1024, 128)
    args = (qt.packed, qt.scales, qt.zeros)
    with pytest.raises(ValueError, match="no kernel"):
        gemv.w8a8_fused(torch.zeros((1, 1024), device="meta"), *args, 128,
                        torch.float32)
    for fn in (gemv.w8a8, gemv.int8_post):
        with pytest.raises(ValueError, match="group_size"):
            fn(torch.zeros((1, 1024)), *args, 64, torch.float32)
    for g in (8, 48, 192):
        with pytest.raises(ValueError, match="group_size"):
            gemv.int8_fused(torch.zeros((1, 1024)), *args, g, torch.float32)
    with pytest.raises(ValueError, match="m=64"):
        gemv.quantized_matmul(torch.zeros((65, 1024)), *args,
                              group_size=128, fmt="w8a8q")
