"""The fused LUT matmuls of the port (their plain PyTorch versions, which the
wrappers run on CPU tensors) against the JAX package's Pallas kernels in
interpret mode, on the same codes: each case is a JAX ``QuantizedTensor``
carried over by ``any4_tpu_torch.convert``.

Cases: any4t g=128 and any4 ``layout="row"`` g=128 (TPU kernels _q4t_kernel
and _q4post_kernel; port kernel A), any4 g=64 and g=32 (_q4_kernel; kernel
B), nf4t/fp4t (_q4t_kernel with a global LUT; kernel A).

Bars:
- float32 output within 1e-4 * max|ref| of the JAX kernel: the rounding
  points are the same and bf16 x bf16 products are exact in float32, so only
  the order of the float32 sums differs;
- within the repo's 2e-2 (``tests/kernels/test_gemv.py::_assert_close``) of
  ``dequantize_tensor`` + a float32 matmul;
- a negated LUT negates the output (the LUT is really read);
- kernel B on the identity matrix reproduces x bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.ops import linear as jlin
from any4_tpu.ops.pallas import gemv as jgemv
from any4_tpu_torch.ops import gemv, linear as tlin
from test_torch_convert import assert_close_max, jax_to_numpy
from any4_tpu_torch import convert

CASES = [  # (name, fmt, group_size, layout, port kernel)
    ("any4t_g128", "any4", 128, None, "q4_lut_post"),
    ("any4row_g128", "any4", 128, "row", "q4_lut_post"),
    ("any4_g64", "any4", 64, None, "q4_lut_fused"),
    ("any4_g32", "any4", 32, None, "q4_lut_fused"),
    ("nf4t_g128", "nf4", 128, None, "q4_lut_post"),
    ("fp4t_g128", "fp4", 128, None, "q4_lut_post"),
]
# (m, k, n): every m in {1, 5, 16, 40}, k in {1024, 1536, 2048} and n in
# {256, 384} is run, each shape on a few cases (the interpreted Pallas
# kernels take seconds per shape)
SHAPES = {
    "any4t_g128": [(16, 2048, 384)],
    "any4row_g128": [(5, 1536, 384)],
    "any4_g64": [(40, 1024, 384), (1, 2048, 256)],
    "any4_g32": [(16, 1536, 256)],
    "nf4t_g128": [(5, 1024, 256)],
    "fp4t_g128": [(40, 1536, 384)],
}


def _pair(fmt, g, layout, n, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    kw = dict(kmeans_iters=4, init="int") if fmt == "any4" else {}
    if layout:
        kw["layout"] = layout
    jqt = jlin.quantize_tensor(jnp.asarray(w), fmt, group_size=g, **kw)
    return jqt, convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")


def _jax_mm(x, jqt, out_dtype=jnp.float32):
    return np.asarray(jgemv.quantized_matmul(
        jnp.asarray(x), jqt.packed, jqt.scales, jqt.zeros, jqt.lut,
        fmt=jlin._kernel_fmt(jqt.fmt, jqt.lut), group_size=jqt.group_size,
        n=jqt.shape[0], interpret=True, out_dtype=out_dtype).astype(
            jnp.float32))


def _port_mm(x, qt, out_dtype=torch.float32):
    return gemv.quantized_matmul(
        torch.from_numpy(x), qt.packed, qt.scales, qt.zeros, qt.lut,
        group_size=qt.group_size, out_dtype=out_dtype)


@pytest.mark.parametrize(
    "case,m,k,n", [(c, *s) for c in CASES for s in SHAPES[c[0]]],
    ids=[f"{c[0]}-{'-'.join(map(str, s))}" for c in CASES
         for s in SHAPES[c[0]]])
def test_plain_matches_jax_kernel(case, m, k, n):
    _, fmt, g, layout, kernel = case
    jqt, qt = _pair(fmt, g, layout, n, k, seed=m)
    x = np.random.default_rng(k + m).standard_normal((m, k)).astype(
        np.float32)
    before = dict(gemv.LAUNCHES)
    y = _port_mm(x, qt)
    assert gemv.LAUNCHES == before      # CPU tensors launch nothing
    assert y.shape == (m, n) and y.dtype == torch.float32
    assert_close_max(y, _jax_mm(x, jqt), 1e-4)
    ref = x @ np.asarray(jlin.dequantize_tensor(jqt, dtype=jnp.float32)).T
    assert_close_max(y, ref, 2e-2)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_routes_to_its_kernel(case, monkeypatch):
    _, fmt, g, layout, kernel = case
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (128, 1024)).astype(np.float32))
    kw = dict(kmeans_iters=1, init="int") if fmt == "any4" else {}
    qt = tlin.quantize_tensor(w, fmt, g, layout=layout, **kw)
    seen = []
    for name in ("q4_lut_post_plain", "q4_lut_fused_plain"):
        orig = getattr(gemv, name)
        monkeypatch.setattr(gemv, name, lambda *a, _o=orig, _n=name:
                            seen.append(_n) or _o(*a))
    _port_mm(np.ones((2, 1024), np.float32), qt)
    assert seen == [kernel + "_plain"]


@pytest.mark.parametrize("g", [128, 64])
def test_negated_lut_negates_output(g):
    _, qt = _pair("any4", g, None, 256, 1024, seed=3)
    x = np.random.default_rng(4).standard_normal((3, 1024)).astype(
        np.float32)
    qt.zeros.zero_()
    y = _port_mm(x, qt)
    qt.lut.neg_()
    np.testing.assert_array_equal(_port_mm(x, qt).numpy(), -y.numpy())
    assert float(y.abs().max()) > 0


def test_fused_identity_bit_exact():
    """W = I through kernel B in bf16 gives x back exactly, as the JAX
    fused-table kernel does: every weight is exactly 0 or 1 after its
    bf16(lut*s + z) rounding."""
    k = 1024
    jqt = jlin.quantize_tensor(jnp.eye(k, dtype=jnp.float32), "any4",
                               group_size=64, init="int", kmeans_iters=5)
    qt = convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")
    x = np.asarray(jnp.asarray(np.random.default_rng(5).standard_normal(
        (4, k)), jnp.bfloat16).astype(jnp.float32))
    y = _port_mm(x, qt, torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(y, x)
    np.testing.assert_array_equal(y, _jax_mm(x, jqt, jnp.bfloat16))


def test_global_lut_plain_equals_broadcast():
    _, qt = _pair("nf4", 128, None, 128, 1024, seed=6)
    x = np.random.default_rng(7).standard_normal((2, 1024)).astype(
        np.float32)
    y = _port_mm(x, qt)
    qt.lut = qt.lut.expand(128, 16).contiguous()
    np.testing.assert_array_equal(_port_mm(x, qt).numpy(), y.numpy())


def test_wrapper_validates_device():
    _, qt = _pair("nf4", 128, None, 128, 1024)
    with pytest.raises(ValueError, match="no kernel"):
        gemv.q4_lut_post(torch.zeros((1, 1024), device="meta"), qt.packed,
                         qt.scales, qt.zeros, qt.lut, 128, torch.float32)
    with pytest.raises(ValueError, match="group_size"):
        gemv.q4_lut_post(torch.zeros((1, 1024)), qt.packed, qt.scales,
                         qt.zeros, qt.lut, 64, torch.float32)
