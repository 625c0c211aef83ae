"""Carrying weights between the JAX package and the PyTorch port.

Also the shared helpers of the ``test_torch_*`` files: trees go from JAX to
numpy (quantized weights as dicts of their fields) and into the port through
``any4_tpu_torch.convert``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.ops import linear as jlin
from any4_tpu_torch import convert
from any4_tpu_torch.ops import linear as tlin

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def jax_to_numpy(tree):
    """A JAX parameter tree as the numpy tree ``convert`` reads."""
    if isinstance(tree, jlin.QuantizedTensor):
        d = {f: None if getattr(tree, f) is None else
             np.asarray(getattr(tree, f)) for f in convert.QT_FIELDS}
        d.update(fmt=tree.fmt, group_size=tree.group_size,
                 shape=tuple(tree.shape), dtype=str(jnp.dtype(tree.dtype)),
                 row_shards=tree.row_shards)
        return d
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_to_numpy(v) for v in tree]
    a = np.asarray(tree)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def assert_close_max(y, ref, tol):
    """``|y - ref| <= tol * max|ref|`` elementwise."""
    y = np.asarray(torch.as_tensor(y).float() if isinstance(y, torch.Tensor)
                   else y, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    err = float(np.abs(y - ref).max())
    assert err <= tol * scale, (err, tol * scale)


def _jax_qt(fmt, n, k, g, seed=0, **kw):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return jlin.quantize_tensor(jnp.asarray(w), fmt, group_size=g, **kw)


@pytest.mark.parametrize("fmt,g,layout", [
    ("any4", 128, None), ("any4", 128, "row"), ("any4", 64, None),
    ("nf4", 128, None), ("fp4", 32, None)])
def test_qt_round_trip(fmt, g, layout):
    kw = dict(kmeans_iters=2, init="int") if fmt == "any4" else {}
    if layout:
        kw["layout"] = layout
    qt = _jax_qt(fmt, 48, 1536, g, **kw)
    port = convert.qt_from_jax(jax_to_numpy(qt), device="cpu")
    assert port.fmt == qt.fmt and port.shape == (48, 1536)
    assert port.lut.shape[1] == 16
    back = convert.qt_to_jax(port)
    for f in convert.QT_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(qt, f)))


def test_dense_bf16_round_trip():
    a = jnp.asarray(np.random.default_rng(1).standard_normal((5, 7)),
                    jnp.bfloat16)
    t = convert.tensor_from_numpy(jax_to_numpy(a), device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))
    np.testing.assert_array_equal(convert.tensor_to_numpy(t),
                                  jax_to_numpy(a))


def test_unported_format_raises():
    """int8p, the last format the port lacked, now carries across: the
    split-byte planes become int8 codes and back, and the JAX fields come
    back as they were (an unknown name is refused)."""
    qt = _jax_qt("int8p", 16, 1024, 128)
    port = convert.qt_from_jax(jax_to_numpy(qt), device="cpu")
    assert port.fmt == "int8p" and port.packed.dtype == torch.int8
    back = convert.qt_to_jax(port)
    for f in ("packed", "scales"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(qt, f)))
    assert_close_max(back["zeros"], np.asarray(qt.zeros), 1e-6)
    own = tlin.quantize_tensor(torch.zeros(16, 1024), "int8p")
    assert own.fmt == "int8p" and own.packed.shape == (16, 1024)
    with pytest.raises(ValueError, match="unsupported fmt"):
        convert.qt_from_jax({**jax_to_numpy(qt), "fmt": "int3"}, device="cpu")


def test_row_shards_raise():
    w = np.random.default_rng(2).standard_normal((16, 2048)).astype(
        np.float32)
    qt = jlin.quantize_tensor(jnp.asarray(w), "nf4", 128, row_shards=2)
    with pytest.raises(NotImplementedError, match="item 12"):
        convert.qt_from_jax(jax_to_numpy(qt), device="cpu")
