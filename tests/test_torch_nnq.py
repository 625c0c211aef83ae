"""The port's nnq LUT refinement (``any4_tpu_torch.quant.nnq``), the
agglomerative any4 backend and ``any4_reconstruct`` against the JAX
package, on the CPU.

Bars:
- ``learn_lut`` with the same start and activations: for each objective,
  the final loss (of the returned sorted LUT and its reassignment) within
  1% of JAX's (Adam rounds in another order than optax, and a hard
  assignment may flip on a one-ulp LUT change); a sorted f32 LUT and uint8
  codes;
- ``agglomerative_rows`` (scipy's Ward tree, cut as scikit-learn cuts it)
  equal to JAX's (scikit-learn) on random rows, rows with ties and with
  sample weights: the same assignment, centroids within 1e-6;
- ``any4_reconstruct``: bit for bit with the agglomerative backend, and
  within the learner's bar (1e-4 of the weights' range) with k-means from
  the int init.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.quant import anyq as janyq
from any4_tpu.quant import kmeans as jkmeans
from any4_tpu.quant import nnq as jnnq
from any4_tpu_torch.quant import anyq, kmeans, nnq


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _loss(objective, lut, codes, scales, zeros, w, x, g):
    """An objective in numpy float64, from ``(lut [n, 16], codes [n, k])``
    in the group-normalized domain."""
    lut, codes = np.asarray(lut, np.float64), np.asarray(codes, np.int64)
    n, k = codes.shape
    vals = np.take_along_axis(lut, codes, axis=1) - 8.0
    wq = (vals.reshape(n, k // g, g) * np.asarray(scales)[..., None]
          + np.asarray(zeros)[..., None]).reshape(n, k)
    w = np.asarray(w, np.float64)

    def nlc(out, lab):
        cos = np.abs(np.mean((out * lab).sum(-1) / (
            np.linalg.norm(out, axis=-1) * np.linalg.norm(lab, axis=-1)
            + 1e-8)))
        return -np.log(max(cos, 1e-8))

    if objective == "w_mse":
        return np.mean((wq - w) ** 2)
    if objective == "w_cossim":
        return nlc(wq, w)
    y, yq = x @ w.T, x @ wq.T
    if objective == "y_cossim":
        return nlc(yq.T, y.T)
    return np.mean((y - yq) ** 2)


@pytest.mark.parametrize("objective", nnq.OBJECTIVES)
def test_learn_lut_matches_jax(objective):
    g = 32
    w = _w((8, 128), 0)
    x = _w((64, 128), 1)
    codes, lut, scales, zeros = janyq.any4_quantize(
        jnp.asarray(w), group_size=g, init="int", kmeans_iters=3)
    kw = dict(group_size=g, objective=objective, steps=60, lr=2e-2)
    jlut, jcodes = jnnq.learn_lut(jnp.asarray(w), lut, scales, zeros,
                                  sample_activations=jnp.asarray(x), **kw)
    tlut, tcodes = nnq.learn_lut(torch.from_numpy(w),
                                 torch.from_numpy(np.array(lut)),
                                 torch.from_numpy(np.array(scales)),
                                 torch.from_numpy(np.array(zeros)),
                                 sample_activations=torch.from_numpy(x), **kw)
    assert tlut.dtype == torch.float32 and tcodes.dtype == torch.uint8
    assert bool((tlut[:, 1:] >= tlut[:, :-1]).all())
    x64 = x.astype(np.float64)
    start = _loss(objective, lut, codes, scales, zeros, w, x64, g)
    ref = _loss(objective, jlut, jcodes, scales, zeros, w, x64, g)
    got = _loss(objective, tlut, tcodes, scales, zeros, w, x64, g)
    assert ref < start
    assert abs(got - ref) <= 0.01 * abs(ref), (got, ref, start)


def test_learn_lut_draws_activations_from_seed():
    w = torch.from_numpy(_w((4, 64), 2))
    codes, lut, scales, zeros = anyq.any4_quantize(w, group_size=32,
                                                   init="int", kmeans_iters=2)
    runs = [nnq.learn_lut(w, lut, scales, zeros, group_size=32, steps=5,
                          seed=s) for s in (0, 0, 1)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], runs[2][0])
    with pytest.raises(ValueError, match="objective"):
        nnq.learn_lut(w, lut, scales, zeros, group_size=32, objective="mse")


def test_any4_quantize_nnq():
    """nnq through any4_quantize refines the k-means LUT without making
    the weight error worse (JAX's own check), with codes in [0, 15]."""
    w = _w((8, 256), 3)
    kw = dict(group_size=64, init="int", kmeans_iters=3)
    codes0, lut0, scales, zeros = anyq.any4_quantize(torch.from_numpy(w),
                                                     **kw)
    codes, lut, scales1, zeros1 = anyq.any4_quantize(
        torch.from_numpy(w), nnq=True,
        nnq_args={"objective": "w_mse", "steps": 100, "lr": 5e-2}, **kw)
    assert lut.shape == (8, 16) and codes.dtype == torch.uint8
    assert int(codes.max()) <= 15
    assert torch.equal(scales, scales1) and torch.equal(zeros, zeros1)
    e0 = _loss("w_mse", lut0, codes0.long(), scales, zeros, w, None, 64)
    e1 = _loss("w_mse", lut, codes.long(), scales, zeros, w, None, 64)
    assert e1 <= e0
    with pytest.raises(ValueError, match="per_row"):
        anyq.any4_quantize(torch.from_numpy(w), nnq=True, per_row=False)


def _rows(kind):
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 15, (12, 96))
    if kind == "ties":      # rows of repeated values
        x = np.round(x)
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "weighted",
                                  "row_weights"])
def test_agglomerative_matches_jax(kind):
    x = _rows("ties" if kind == "ties" else "random")
    rng = np.random.default_rng(5)
    sw = {"weighted": rng.uniform(0, 2, 96),
          "row_weights": rng.uniform(0, 2, (12, 96))}.get(kind)
    if sw is not None:
        sw = sw.astype(np.float32)
        sw[..., :8] = 0.0       # a cluster may weigh nothing
    ref_c, ref_a = jkmeans.agglomerative_rows(x, 16, sample_weight=sw)
    c, a = kmeans.agglomerative_rows(
        torch.from_numpy(x), 16,
        sample_weight=None if sw is None else torch.from_numpy(sw))
    assert c.dtype == torch.float32 and a.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref_a))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), atol=1e-6,
                               rtol=0)


def test_any4_quantize_agglomerative_matches_jax():
    w = _w((6, 128), 6)
    sw = np.random.default_rng(7).uniform(0.5, 2, 128).astype(np.float32)
    ref = janyq.any4_quantize(jnp.asarray(w), group_size=64,
                              cluster_backend="agglomerative",
                              sample_weight=jnp.asarray(sw))
    out = anyq.any4_quantize(torch.from_numpy(w), group_size=64,
                             cluster_backend="agglomerative",
                             sample_weight=torch.from_numpy(sw))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="cluster_backend"):
        anyq.any4_quantize(torch.from_numpy(w), cluster_backend="gmm")


@pytest.mark.parametrize("kw", [
    dict(cluster_backend="agglomerative"),
    dict(init="int", kmeans_iters=4),
    dict(init="int", kmeans_iters=4, per_row=False),
], ids=["agglomerative", "kmeans_int", "global_lut"])
def test_any4_reconstruct_matches_jax(kw):
    w = _w((8, 128), 8)
    ref = np.asarray(janyq.any4_reconstruct(jnp.asarray(w), group_size=32,
                                            **kw))
    out = anyq.any4_reconstruct(torch.from_numpy(w), group_size=32, **kw)
    assert out.dtype == torch.float32 and out.shape == w.shape
    if kw.get("cluster_backend") == "agglomerative":
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-4 * float(np.ptp(w)))
    bf = anyq.any4_reconstruct(torch.from_numpy(w).to(torch.bfloat16),
                               group_size=32, **kw)
    assert bf.dtype == torch.bfloat16
