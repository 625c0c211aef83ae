"""The port's weight and quantization analysis and model diff
(``any4_tpu_torch/evals/analyze.py``) against the JAX package's, on the CPU.

Weights come from numpy seeds, or from the JAX package's float32
``LlamaConfig.tiny`` (vocab 256, 2 layers) carried across as numpy. Bars:
- ``weight_stats``: equal (the same numpy code on the same weights);
- ``quant_error`` on the same numpy x: int4 and nf4 ``w_mse``, ``y_mse``
  and ``y_cossim`` within 1e-5 relative (the same codes; float32 sums in
  another order); any4 ``w_mse`` no more than 1% above JAX's at 128 x
  2048 and 30 k-means iterations, the repo's bar for k-means++ started
  from other random draws (``tests/test_torch_quant.py``);
- ``analyze_model``: the CSV header and the statistics of JAX's, int4 and
  nf4 ``w_mse`` as above, any4's below int4's in both (one 64 x 64 weight,
  where the seed noise of k-means exceeds 1%); x is drawn from a
  ``torch.Generator``, so the Y columns are held to be finite only;
- ``diff_models`` on the same dense and pseudo-quantized pair: MSE and
  cosine within 1e-5 relative of JAX's; a model against itself gives 0.
"""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.evals import analyze as janalyze
from any4_tpu.models import llama as jllama
from any4_tpu.quant import api as japi
from any4_tpu_torch import convert
from any4_tpu_torch.evals import analyze
from any4_tpu_torch.models import llama, opt
from any4_tpu_torch.quant import api
from test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from test_torch_convert import jax_to_numpy

TOL = 1e-5
ANY4_W_MSE_TOL = 1e-2      # above JAX's, at 128 x 2048 and 30 iterations


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params): the same float32
    tiny model."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab=256, layers=2),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab=256, layers=2),
                               dtype=torch.float32)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, convert.from_jax_params(jax_to_numpy(jp),
                                                   device="cpu")


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("shape,seed", [((64, 256), 0), ((7, 33), 1),
                                        ((128, 512), 2)])
def test_weight_stats_equal(shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    assert analyze.weight_stats(w) == janalyze.weight_stats(w)


@pytest.mark.parametrize("fmt,g", [("int4", 32), ("int4", 128), ("nf4", 64),
                                   ("nf4", 128)])
def test_quant_error_matches_jax(fmt, g):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    x = rng.standard_normal((16, 256)).astype(np.float32)
    got = analyze.quant_error(torch.from_numpy(w), fmt, g,
                              x=torch.from_numpy(x))
    ref = janalyze.quant_error(jnp.asarray(w), fmt, g, x=jnp.asarray(x))
    assert got.keys() == ref.keys() == {"w_mse", "y_mse", "y_cossim"}
    for k in got:
        assert _rel(got[k], ref[k]) <= TOL, (k, got[k], ref[k])


def test_quant_error_any4_w_mse_within_kmeans_noise():
    """With a sample weight, as ``analyze_model`` passes calibrated ones."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((128, 2048)).astype(np.float32)
    sw = rng.random(2048).astype(np.float32) + 0.5
    got = analyze.quant_error(torch.from_numpy(w), "any4", 128,
                              sample_weight=sw, kmeans_iters=30)
    ref = janalyze.quant_error(jnp.asarray(w), "any4", 128,
                               sample_weight=jnp.asarray(sw),
                               kmeans_iters=30)
    assert got["w_mse"] <= ref["w_mse"] * (1 + ANY4_W_MSE_TOL)
    # any4's learned table beats int4's uniform grid
    assert got["w_mse"] < analyze.quant_error(
        torch.from_numpy(w), "int4", 128)["w_mse"]


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


def test_analyze_model_matches_jax(models, tmp_path):
    """One weight with int4, nf4 and any4: JAX's CSV header, statistics
    and int4/nf4 ``w_mse``; then every weight of the model with int4: JAX's
    layers and their statistics."""
    _, jp, _, tp = models
    fmts = ["int4", "nf4", "any4"]
    kw = dict(fmts=fmts, group_size=32, calib_batch=8)
    [got] = analyze.analyze_model(
        tp, out_dir=str(tmp_path / "port"), device="cpu",
        layer_filter=lambda n, l: n == "layers.0.q_proj", **kw)
    [ref] = janalyze.analyze_model(
        jp, out_dir=str(tmp_path / "jax"),
        layer_filter=lambda n, l: n == "layers.0.q_proj", **kw)
    assert _header(tmp_path / "port" / "stats.csv") == \
        _header(tmp_path / "jax" / "stats.csv") == list(got)
    for k in ("layer", "shape", "mean", "std", "min", "max", "entropy"):
        assert got[k] == ref[k], k
    for f in fmts:
        if f != "any4":
            assert _rel(got[f"{f}_w_mse"], ref[f"{f}_w_mse"]) <= TOL
        assert np.isfinite([got[f"{f}_y_mse"], got[f"{f}_y_cossim"]]).all()
    assert got["any4_w_mse"] < got["int4_w_mse"]
    assert ref["any4_w_mse"] < ref["int4_w_mse"]
    rows = analyze.analyze_model(tp, fmts=["int4"], group_size=32,
                                 calib_batch=8, device="cpu")
    want = [(name, janalyze.weight_stats(np.asarray(leaf, np.float32)))
            for name, leaf, _ in japi._walk(jp)
            if japi.default_layer_filter(name, leaf)]
    assert len(rows) == len(want) == 15
    for r, (name, stats) in zip(rows, want):
        assert r["layer"] == name
        assert {k: r[k] for k in stats} == stats


def test_analyze_x_from_seed(models):
    """The Y-space draws come from ``seed``: equal rows for one seed."""
    _, _, _, tp = models
    kw = dict(fmts=["int4"], group_size=32, calib_batch=4, device="cpu")
    a = analyze.analyze_model(tp, seed=3, **kw)
    assert a == analyze.analyze_model(tp, seed=3, **kw)
    assert a != analyze.analyze_model(tp, seed=4, **kw)


def _jax_tree(tree):
    """A port tree of dense float32 tensors as JAX arrays."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree.numpy())


def test_diff_models_matches_jax(models, tmp_path):
    """The pair: the model and the port's pseudo-int4 copy of it (JAX
    quantizes eagerly, seconds a weight shape)."""
    jcfg, jp, tcfg, tp = models
    tq = api.quantize_model(tp, fmt="int4", group_size=32, pseudo=True,
                            device="cpu")
    jq = _jax_tree(tq)
    ids = np.random.default_rng(1).integers(0, 256, (1, 16)).astype(np.int32)
    got = analyze.diff_models(tp, tq, tcfg, torch.from_numpy(ids),
                              out_dir=str(tmp_path))
    ref = janalyze.diff_models(jp, jq, jcfg, jnp.asarray(ids))
    assert [r["layer"] for r in got] == [r["layer"] for r in ref]
    assert got[-1]["layer"] == "logits" and len(got) == 2 * 7 + 1
    for g, r in zip(got, ref):
        assert _rel(g["mse"], r["mse"]) <= TOL, (g, r)
        assert _rel(g["cossim"], r["cossim"]) <= TOL, (g, r)
    assert _header(tmp_path / "diffs.csv") == ["layer", "mse", "cossim"]
    same = analyze.diff_models(tp, tp, tcfg, torch.from_numpy(ids))
    assert all(r["mse"] == 0.0 for r in same)


def test_diff_models_other_forward():
    """``forward_fn`` diffs the OPT forward, which captures too."""
    cfg = opt.OPTConfig.tiny()
    params = opt.init_params(cfg, seed=0, device="cpu")
    q = api.quantize_model(params, fmt="int4", group_size=32, pseudo=True,
                           device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (1, 12),
                        generator=torch.Generator().manual_seed(0))
    rows = analyze.diff_models(params, q, cfg, ids, forward_fn=opt.forward)
    assert rows[-1]["layer"] == "logits" and len(rows) == 2 * 6 + 1
    assert all(0.5 < r["cossim"] <= 1.0 + 1e-6 for r in rows)
