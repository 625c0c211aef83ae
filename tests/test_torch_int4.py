"""int4, int4p and W4A8 in the port against the JAX package (CPU): the
quantizers, the TPU layouts' numpy copies, the plain versions of kernels C
(``q4_int4_magic``), D (``w4a8``), D-fused (``w4a8_fused``) and E
(``q4_lut_select``), and ``linear``'s routing.

The JAX side quantizes ``jnp`` arrays (its numpy input takes a native C++
path whose scales agree only to rtol 1e-6) and runs its Pallas kernels in
interpret mode. Bars:

- ``group_quantize`` (all three branches), ``dequantize_tensor`` and
  ``quantize_activations``: bit-equal in f32;
- plain C and E within 1e-4 * max|ref| of JAX's kernels (same rounding
  points, f32 sums in another order; int4p's ``128 + c`` terms cancel in
  f32 by design); plain D and D-fused within 1e-5 (their integer dots are
  exact); int4p within 2e-2 of ``dequantize_tensor`` + an f32 matmul, w4a8
  within 1e-3 of the fake-quant reference ``(xq * sx) @ dequant(W)^T``;
- fused and external W4A8 within 1e-5 of each other at m in {1, 16, 64};
- select against gather: int4 bit-equal, any4/nf4 within 5e-3.
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


def _w(n, k, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _pair(fmt, n, k, g, seed=0, **kw):
    jqt = jlin.quantize_tensor(jnp.asarray(_w(n, k, seed)), fmt,
                               group_size=g, **kw)
    return jqt, convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")


def _jax_kernel(x, jqt, use_gather=True, out_dtype=jnp.float32):
    return np.asarray(jgemv.quantized_matmul(
        jnp.asarray(x), jqt.packed, jqt.scales, jqt.zeros, jqt.lut,
        fmt=jlin._kernel_fmt(jqt.fmt, jqt.lut), group_size=jqt.group_size,
        n=jqt.shape[0], use_gather=use_gather, interpret=True,
        out_dtype=out_dtype).astype(jnp.float32))


def _port_kernel(x, qt, use_gather=True, out_dtype=torch.float32):
    return gemv.quantized_matmul(
        torch.from_numpy(x), qt.packed, qt.scales, qt.zeros, qt.lut,
        group_size=qt.group_size, out_dtype=out_dtype,
        fmt=tlin._kernel_fmt(qt.fmt, qt.lut), use_gather=use_gather)


def _dequant_ref(x, jqt):
    return x @ np.asarray(jlin.dequantize_tensor(jqt, dtype=jnp.float32)).T


QUANT_MODES = [(False, False), (True, False), (False, True)]
QUANT_IDS = ["asymmetric", "symmetric", "int_zeros"]


@pytest.mark.parametrize("symmetric,int_zeros", QUANT_MODES, ids=QUANT_IDS)
@pytest.mark.parametrize("g", [128, 64])
def test_group_quantize_bit_equal(symmetric, int_zeros, g):
    w = _w(130, 1408, seed=g)
    w[3, :g] = 0.0                                  # a constant group
    ref = jquant.group_quantize(jnp.asarray(w), 4, g, symmetric=symmetric,
                                int_zeros=int_zeros)
    got = quant.group_quantize(torch.from_numpy(w), 4, g,
                               symmetric=symmetric, int_zeros=int_zeros)
    for a, b in zip(got, ref):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        quant.group_dequantize(*got, 4, g).numpy(),
        np.asarray(jquant.group_dequantize(*ref, 4, g)))


@pytest.mark.parametrize("fmt,g,layout", [
    ("int4", 128, None), ("int4", 256, None), ("int4", 128, "row"),
    ("int4", 64, None), ("w4a8", 128, None), ("int4p", 128, None)])
@pytest.mark.parametrize("symmetric,int_zeros", QUANT_MODES, ids=QUANT_IDS)
def test_quantize_tensor_bit_equal(fmt, g, layout, symmetric, int_zeros):
    """The port's own quantization gives JAX's format name, codes, scales
    and zeros, and its dequantized weight bit for bit."""
    kw = dict(scale_only=symmetric, int_zeros=int_zeros)
    if layout:
        kw["layout"] = layout
    w = _w(132, 1536, seed=7)
    jqt = jlin.quantize_tensor(jnp.asarray(w), fmt, group_size=g, **kw)
    qt = tlin.quantize_tensor(torch.from_numpy(w), fmt, g, **kw)
    ref = convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")
    assert qt.fmt == jqt.fmt and qt.lut is None and qt.group_size == g
    for f in ("packed", "scales", "zeros"):
        assert torch.equal(getattr(qt, f), getattr(ref, f)), f
    np.testing.assert_array_equal(
        tlin.dequantize_tensor(qt, torch.float32).numpy(),
        np.asarray(jlin.dequantize_tensor(jqt, jnp.float32)))
    back = convert.qt_to_jax(qt)
    np.testing.assert_array_equal(back["packed"], np.asarray(jqt.packed))
    assert back["lut"] is None


def test_int_format_checks():
    w = torch.from_numpy(_w(130, 1024))
    assert tlin.quantize_tensor(w[:129], "int4", 128).fmt == "int4"  # odd n
    assert tlin.quantize_tensor(w, "int4", 128, layout="row").fmt == "int4"
    for fmt, n, g in (("w4a8", 130, 128), ("w4a8", 128, 64),
                      ("int4p", 128, 64), ("int4p", 129, 128)):
        with pytest.raises(ValueError):
            tlin.quantize_tensor(w[:n], fmt, g)
    with pytest.raises(ValueError, match="int_zeros"):
        tlin.quantize_tensor(w, "nf4", 128, int_zeros=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_bit_equal(dtype):
    x = _w(6, 1408, seed=3) * 4.0
    x[1] = 0.0                                      # the 1e-8 floor
    x[2, :] = 0.0                                   # x / sx lands on k + 0.5
    x[2, :5] = [127.0, 0.5, 1.5, -2.5, 3.5]
    x = x.reshape(2, 3, 1408)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = convert.tensor_from_numpy(jax_to_numpy(xj), device="cpu")
    xq, sx = quant.quantize_activations(xt)
    rq, rsx = jlin.quantize_activations(xj)
    assert xq.dtype == torch.int8 and sx.shape == (2, 3, 1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(rsx))
    np.testing.assert_array_equal(xq[0, 2, :5].numpy(), [127, 0, 2, -2, 4])


def test_tpu_layouts_equal_jax_and_round_trip():
    codes = np.random.default_rng(4).integers(0, 16, (132, 1408)).astype(
        np.uint8)
    for name in ("pair", "quad"):
        pack = getattr(packing, f"pack_int4_{name}")
        unpack = getattr(packing, f"unpack_int4_{name}")
        words = pack(codes)
        np.testing.assert_array_equal(
            words, np.asarray(getattr(jpack, f"pack_int4_{name}")(
                jnp.asarray(codes))))
        np.testing.assert_array_equal(unpack(words, 1408), codes)
        np.testing.assert_array_equal(
            unpack(words, 1408),
            np.asarray(getattr(jpack, f"unpack_int4_{name}")(
                jnp.asarray(words), 1408)))
    with pytest.raises(ValueError, match="n % 4"):
        packing.pack_int4_quad(codes[:130])


# (fmt, n, k, g, m): the plain kernel against the interpreted JAX kernel
KERNEL_CASES = [
    ("int4p", 130, 1408, 128, 1), ("int4p", 130, 1536, 256, 16),
    ("int4p", 256, 2048, 128, 5),
    ("w4a8", 128, 1408, 128, 1), ("w4a8", 256, 2048, 256, 16),
    ("w4a8", 128, 4096, 128, 64),
]


@pytest.mark.parametrize("fmt,n,k,g,m", KERNEL_CASES,
                         ids=["-".join(map(str, c)) for c in KERNEL_CASES])
def test_plain_matches_jax_kernel(fmt, n, k, g, m):
    """int4p: kernel C; w4a8 float x: kernel D-fused; w4a8 int8 x: kernel
    D (the JAX kernel's f32 output before the ``* sx``)."""
    jqt, qt = _pair("int4" if fmt == "int4p" else fmt, n, k, g, seed=m)
    assert qt.fmt == fmt
    x = _w(m, k, seed=k + m)
    before = dict(gemv.LAUNCHES)
    y = _port_kernel(x, qt)
    assert gemv.LAUNCHES == before      # CPU tensors launch nothing
    assert y.shape == (m, n) and y.dtype == torch.float32
    if fmt == "int4p":
        assert_close_max(y, _jax_kernel(x, jqt), 1e-4)
        assert_close_max(y, _dequant_ref(x, jqt), 2e-2)
        return
    assert_close_max(y, _jax_kernel(x, jqt), 1e-5)
    xq, sx = jlin.quantize_activations(jnp.asarray(x))
    xd = np.asarray(xq, np.float32) * np.asarray(sx)
    assert_close_max(y, _dequant_ref(xd, jqt), 1e-3)
    xq = np.asarray(xq)
    yq = gemv.w4a8(torch.from_numpy(xq), qt.packed, qt.scales, qt.zeros, g)
    assert yq.dtype == torch.float32
    assert_close_max(yq, _jax_kernel(xq, jqt), 1e-5)


@pytest.mark.parametrize("m", [1, 16, gemv.FUSED_ACT_M_MAX])
def test_fused_act_quant_matches_external(m):
    _, qt = _pair("w4a8", 128, 4096, 128, seed=8)
    x = torch.from_numpy(_w(m, 4096, seed=99 + m))
    fused = gemv.w4a8_fused(x, qt.packed, qt.scales, qt.zeros, 128,
                            torch.float32)
    xq, sx = quant.quantize_activations(x)
    ext = gemv.w4a8(xq, qt.packed, qt.scales, qt.zeros, 128) * sx
    assert_close_max(fused, ext.numpy(), 1e-5)


# (fmt, layout, m): the select-LUT kernel E
SELECT_CASES = [("int4", "row", 1), ("int4", "row", 16), ("any4", "row", 3),
                ("nf4", "row", 2)]


@pytest.mark.parametrize("fmt,layout,m", SELECT_CASES,
                         ids=["-".join(map(str, c)) for c in SELECT_CASES])
def test_select_matches_jax_and_gather(fmt, layout, m):
    kw = dict(kmeans_iters=4, init="int") if fmt == "any4" else {}
    jqt, qt = _pair(fmt, 256, 2048, 128, seed=21, layout=layout, **kw)
    assert qt.fmt == fmt
    x = _w(m, 2048, seed=22)
    sel = _port_kernel(x, qt, use_gather=False)
    assert_close_max(sel, _jax_kernel(x, jqt, use_gather=False), 1e-4)
    gather = _port_kernel(x, qt)
    if fmt == "int4":       # both kernel B's function: bit-equal
        np.testing.assert_array_equal(sel.numpy(), gather.numpy())
        np.testing.assert_array_equal(
            sel.numpy(), gemv.q4_lut_fused_plain(
                torch.from_numpy(x), qt.packed, qt.scales, qt.zeros,
                gemv.int4_ramp("cpu"), 128, torch.float32).numpy())
    else:                   # gather runs kernel A: another rounding point
        assert_close_max(sel, gather.numpy(), 5e-3)


def test_select_per_row_lut_bit_equal_to_fused():
    _, qt = _pair("any4", 128, 1024, 128, seed=5, layout="row",
                  kmeans_iters=3, init="nf4")
    x = torch.from_numpy(_w(4, 1024, seed=6))
    args = (x, qt.packed, qt.scales, qt.zeros, qt.lut, 128, torch.bfloat16)
    assert torch.equal(gemv.q4_lut_select(*args), gemv.q4_lut_fused(*args))


def _spy(monkeypatch, names):
    seen = []
    for name in names:
        orig = getattr(gemv, name)
        monkeypatch.setattr(gemv, name, lambda x, *a, _o=orig, _n=name:
                            seen.append((_n, x.shape[0])) or _o(x, *a))
    return seen


PLAINS = ("q4_lut_post_plain", "q4_lut_fused_plain", "q4_int4_magic_plain",
          "q4_lut_select_plain", "w4a8_plain", "w4a8_fused_plain")
# (fmt, layout, use_gather, m) -> the plain versions called, with their m
ROUTES = [
    ("int4", None, True, 3, [("q4_int4_magic_plain", 3)]),
    ("int4", None, False, 3, [("q4_int4_magic_plain", 3)]),
    ("int4", "row", True, 3, [("q4_lut_fused_plain", 3)]),
    ("int4", "row", False, 3, [("q4_lut_select_plain", 3)]),
    ("nf4", "row", False, 2, [("q4_lut_select_plain", 2)]),
    ("nf4", None, False, 2, [("q4_lut_post_plain", 2)]),
    ("w4a8", None, True, 1, [("w4a8_fused_plain", 1)]),
    ("w4a8", None, True, 64, [("w4a8_fused_plain", 64)]),
    ("w4a8", None, True, 65, [("w4a8_plain", 65)]),
    ("w4a8", None, True, 1024, [("w4a8_plain", 1024)]),
    ("w4a8", None, True, 1100, [("w4a8_plain", 1024), ("w4a8_plain", 76)]),
]


@pytest.mark.parametrize("fmt,layout,use_gather,m,want", ROUTES,
                         ids=[f"{r[0]}-{r[1]}-{r[2]}-{r[3]}" for r in ROUTES])
def test_linear_routes(fmt, layout, use_gather, m, want, monkeypatch):
    kw = {"layout": layout} if layout else {}
    qt = tlin.quantize_tensor(torch.from_numpy(_w(128, 1024)), fmt, 128,
                              **kw)
    seen = _spy(monkeypatch, PLAINS)
    y = tlin.linear(torch.from_numpy(_w(m, 1024, seed=1)), qt,
                    use_gather=use_gather)
    assert seen == want and y.shape == (m, 128)


# (fmt, layout, g, lead shape of x)
LINEAR_CASES = [
    ("int4", None, 128, (1,)), ("int4", None, 256, (3,)),
    ("int4", None, 128, (5, 13)), ("int4", "row", 128, (3,)),
    ("int4", None, 64, (65,)),
    ("w4a8", None, 128, (1,)), ("w4a8", None, 128, (3,)),
    ("w4a8", None, 256, (65,)), ("w4a8", None, 128, (2, 550)),
]


@pytest.mark.parametrize("fmt,layout,g,lead", LINEAR_CASES,
                         ids=[f"{c[0]}-{c[1]}-g{c[2]}-"
                              f"{'x'.join(map(str, c[3]))}"
                              for c in LINEAR_CASES])
def test_linear_matches_jax(fmt, layout, g, lead):
    """``linear`` at m = 1, 3, 65 and above ``_int8_m_tile`` (a 3-D x of
    1100 rows), with a bias, against JAX's ``linear``."""
    kw = {"layout": layout} if layout else {}
    jqt, qt = _pair(fmt, 128, 1536, g, seed=len(lead), **kw)
    x = _w(int(np.prod(lead)), 1536, seed=2).reshape(*lead, 1536)
    bias = _w(1, 128, seed=3)[0]
    ref = jlin.linear(jnp.asarray(x), jqt, jnp.asarray(bias), interpret=True)
    y = tlin.linear(torch.from_numpy(x), qt, torch.from_numpy(bias))
    assert y.shape == (*lead, 128) and y.dtype == torch.float32
    assert_close_max(y, np.asarray(ref), 1e-5 if fmt == "w4a8" else 1e-4)


def test_linear_bf16_w4a8_keeps_x_precision():
    """W4A8 quantizes the activations as they come: a bf16 x and the same
    values in f32 give the same codes and so the same f32 sums."""
    _, qt = _pair("w4a8", 128, 1024, 128, seed=9)
    x = torch.from_numpy(_w(3, 1024, seed=10)).to(torch.bfloat16)
    y16 = tlin.linear(x, qt)
    y32 = tlin.linear(x.float(), qt)
    assert y16.dtype == torch.bfloat16
    np.testing.assert_array_equal(y16.float().numpy(),
                                  y32.to(torch.bfloat16).float().numpy())


def test_wrappers_validate():
    _, qt = _pair("w4a8", 128, 1024, 128)
    args = (qt.packed, qt.scales, qt.zeros, 128)
    with pytest.raises(ValueError, match="no kernel"):
        gemv.w4a8_fused(torch.zeros((1, 1024), device="meta"), *args,
                        torch.float32)
    with pytest.raises(ValueError, match="group_size"):
        gemv.q4_int4_magic(torch.zeros((1, 1024)), qt.packed, qt.scales,
                           qt.zeros, 64, torch.float32)
    with pytest.raises(ValueError, match="m=64"):
        gemv.quantized_matmul(torch.zeros((65, 1024)), *args[:3],
                              group_size=128, fmt="w4a8")
    with pytest.raises(ValueError, match="unknown kernel format"):
        gemv.quantized_matmul(torch.zeros((1, 1024)), *args[:3],
                              group_size=128, fmt="int8p")
