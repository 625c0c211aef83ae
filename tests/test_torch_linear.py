"""``QuantizedTensor``, ``quantize_tensor``, ``dequantize_tensor`` and
``linear`` of the port against the JAX package (CPU).

Bars: a JAX ``QuantizedTensor`` carried across dequantizes to exactly the
same float32 weight; ``linear`` is within 1e-4 * max|ref| of JAX's at
float32 (only the order of float32 sums differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.ops import linear as jlin
from any4_tpu_torch import convert
from any4_tpu_torch.ops import gemv, linear as tlin
from test_torch_convert import assert_close_max, jax_to_numpy

FORMATS = [("any4", 128, None), ("any4", 128, "row"), ("any4", 64, None),
           ("nf4", 128, None), ("fp4", 32, None)]


def _w(n, k, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _jqt(fmt, g, layout, n=96, k=1536, seed=0):
    kw = dict(kmeans_iters=3, init="nf4") if fmt == "any4" else {}
    if layout:
        kw["layout"] = layout
    return jlin.quantize_tensor(jnp.asarray(_w(n, k, seed)), fmt,
                                group_size=g, **kw)


@pytest.mark.parametrize("fmt,g,layout", FORMATS)
def test_dequantize_equals_jax(fmt, g, layout):
    jqt = _jqt(fmt, g, layout)
    qt = convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")
    np.testing.assert_array_equal(
        tlin.dequantize_tensor(qt, torch.float32).numpy(),
        np.asarray(jlin.dequantize_tensor(jqt, jnp.float32)))


@pytest.mark.parametrize("fmt,g,layout", FORMATS)
def test_quantize_tensor_matches_jax(fmt, g, layout):
    """The port's own quantization gives the JAX package's format name,
    field shapes and (deterministic init) numbers."""
    jqt = _jqt(fmt, g, layout)
    kw = dict(kmeans_iters=3, init="nf4") if fmt == "any4" else {}
    qt = tlin.quantize_tensor(torch.from_numpy(_w(96, 1536)), fmt, g,
                              layout=layout, **kw)
    assert qt.fmt == jqt.fmt and qt.group_size == jqt.group_size
    assert qt.scales.shape == jqt.scales.shape
    assert qt.lut.shape[1] == 16
    np.testing.assert_allclose(
        tlin.dequantize_tensor(qt, torch.float32).numpy(),
        np.asarray(jlin.dequantize_tensor(jqt, jnp.float32)), atol=1e-4)


def test_narrow_layer_uses_whole_row_group():
    qt = tlin.quantize_tensor(torch.from_numpy(_w(16, 64)), "any4", 128,
                              init="int", kmeans_iters=2)
    assert qt.group_size == 64 and qt.fmt == "any4"
    assert qt.packed.shape == (16, 128) and qt.scales.shape == (16, 16)


@pytest.mark.parametrize("fmt,g,layout", FORMATS[:3])
def test_linear_matches_jax(fmt, g, layout):
    jqt = _jqt(fmt, g, layout, n=128, k=1024, seed=1)
    qt = convert.qt_from_jax(jax_to_numpy(jqt), device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 3, 1024)).astype(
        np.float32)
    bias = np.random.default_rng(3).standard_normal(128).astype(np.float32)
    ref = jlin.linear(jnp.asarray(x), jqt, jnp.asarray(bias), interpret=True)
    y = tlin.linear(torch.from_numpy(x), qt, torch.from_numpy(bias))
    assert y.shape == (2, 3, 128) and y.dtype == torch.float32
    assert_close_max(y, np.asarray(ref), 1e-4)


def test_linear_chunks_large_m(monkeypatch):
    """m above ``fused_m_max`` runs in chunks of that many rows, each one
    kernel call, and gives the one-call result."""
    qt = tlin.quantize_tensor(torch.from_numpy(_w(64, 1024)), "any4", 128,
                              init="int", kmeans_iters=2)
    x = torch.from_numpy(_w(7, 1024, seed=4)).reshape(1, 7, 1024)
    calls = []
    orig = gemv.q4_lut_post_plain
    monkeypatch.setattr(gemv, "q4_lut_post_plain",
                        lambda x2, *a: calls.append(x2.shape[0]) or
                        orig(x2, *a))
    whole = tlin.linear(x, qt)
    chunked = tlin.linear(x, qt, fused_m_max=3)
    assert calls == [7, 3, 3, 1]
    assert chunked.shape == (1, 7, 64)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5 * float(whole.abs().max()))


def test_linear_fused_m_max_zero_dequantizes(monkeypatch):
    qt = tlin.quantize_tensor(torch.from_numpy(_w(64, 1024)), "nf4", 128)
    monkeypatch.setattr(gemv, "quantized_matmul", None)  # must not be used
    x = torch.from_numpy(_w(3, 1024, seed=5)).to(torch.bfloat16)
    y = tlin.linear(x, qt, fused_m_max=0)
    ref = x @ tlin.dequantize_tensor(qt, torch.bfloat16).t()
    np.testing.assert_array_equal(y.float().numpy(), ref.float().numpy())


def test_dense_linear_matches_jax():
    w = _w(48, 80, seed=6)
    x = _w(5, 80, seed=7)
    ref = jlin.linear(jnp.asarray(x), jnp.asarray(w))
    y = tlin.linear(torch.from_numpy(x), torch.from_numpy(w))
    assert_close_max(y, np.asarray(ref), 1e-5)


def test_nbytes_counts_fields():
    qt = tlin.quantize_tensor(torch.from_numpy(_w(64, 1024)), "nf4", 128)
    assert qt.nbytes == 64 * 128 * 4 + 2 * 8 * 64 * 4 + 16 * 4
