"""The forwards' ``capture`` and the port's calibration
(``any4_tpu_torch.calibrate``, ``quantize_model(calibrate_fn=...)``)
against the JAX package, on the CPU, on tiny float32 models.

Bars:
- capture: the same names, and sums within 1e-6 * max (float32 sums run in
  another order), counts equal, for Llama (unfused and fused), Mixtral and
  OPT;
- ``calibrate`` within 1e-6 * max of JAX's (both ``use_abs``, a subset of
  layers, batches of 2 over 3 sequences);
- ``.npz`` files written by either package load in the other;
- ``quantize_model(calibrate_fn=...)`` with the deterministic int init:
  JAX's codes bit for bit and its LUTs within 1e-5 (a few ulps of values
  up to 15: the sample weights and the centroids are float32 sums in
  another order), and bit for bit the port's own
  ``quantize_model(sample_weight=calibrate(...))``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu import calibrate as jcal
from any4_tpu.models import fuse as jfuse
from any4_tpu.models import llama as jllama
from any4_tpu.models import mixtral as jmixtral
from any4_tpu.models import opt as jopt
from any4_tpu.quant import api as japi
from any4_tpu_torch import calibrate, convert
from any4_tpu_torch.models import llama, mixtral, opt
from any4_tpu_torch.quant import api
from test_torch_convert import assert_close_max, jax_to_numpy


def _ids(b=2, t=10, seed=0, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _llama(fused=False):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab=128),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab=128),
                               dtype=torch.float32)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    if fused:
        jp = jfuse.fuse_projections(jp)
    return jllama.forward, llama.forward, jcfg, tcfg, jp


def _mixtral():
    jcfg = dataclasses.replace(jmixtral.MixtralConfig.tiny(vocab=128),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(mixtral.MixtralConfig.tiny(vocab=128),
                               dtype=torch.float32)
    return (jmixtral.forward, mixtral.forward, jcfg, tcfg,
            jmixtral.init_params(jcfg, jax.random.PRNGKey(1)))


def _opt():
    jcfg = dataclasses.replace(jopt.OPTConfig.tiny(vocab=128),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(opt.OPTConfig.tiny(vocab=128),
                               dtype=torch.float32)
    return (jopt.forward, opt.forward, jcfg, tcfg,
            jopt.init_params(jcfg, jax.random.PRNGKey(2)))


MODELS = {"llama": _llama, "llama_fused": lambda: _llama(fused=True),
          "mixtral": _mixtral, "opt": _opt}


def _assert_stats(got, ref):
    assert sorted(got) == sorted(ref)
    for name, (sa, ss, c) in ref.items():
        ga, gs, gc = got[name]
        assert gc == c, name
        assert_close_max(ga, np.asarray(sa), 1e-6)
        assert_close_max(gs, np.asarray(ss), 1e-6)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_capture_matches_jax(model):
    jfwd, tfwd, jcfg, tcfg, jp = MODELS[model]()
    ids = _ids()
    ref, got = {}, {}
    jfwd(jp, jcfg, jnp.asarray(ids), capture=ref)
    logits, _ = tfwd(convert.from_jax_params(jax_to_numpy(jp), device="cpu"),
                     tcfg, torch.from_numpy(ids), capture=got)
    assert logits.shape == (2, 10, 128)
    _assert_stats(got, ref)
    if model == "mixtral":   # every expert's w2 input, over every token
        assert got["layers.0.experts.3.w2"][2] == ids.size


def test_capture_raw_rows():
    """A raw store keeps each recorded input's rows, whose sums are the
    statistics; stacked experts record nothing of the MoE, as in JAX."""
    _, _, _, tcfg, jp = _mixtral()
    params = convert.from_jax_params(jax_to_numpy(jp), device="cpu")
    store = llama.Capture(raw=True)
    mixtral.forward(params, tcfg, torch.from_numpy(_ids(b=1, t=7)),
                    capture=store)
    assert store.rows.keys() == store.keys()
    for name, rows in store.rows.items():
        x = torch.cat(rows)
        assert x.shape[0] == 7 and x.dtype == torch.float32
        torch.testing.assert_close(x.abs().sum(0), store[name][0])
    from any4_tpu_torch.models import fuse
    stacked = fuse.stack_experts(fuse.fuse_projections(params))
    plain = {}
    mixtral.forward(stacked, tcfg, torch.from_numpy(_ids(b=1, t=7)),
                    capture=plain)
    assert not [n for n in plain if "moe" in n or "experts" in n]
    assert "layers.1.q_proj" in plain


@pytest.mark.parametrize("use_abs", [True, False])
def test_calibrate_matches_jax(use_abs):
    jfwd, tfwd, jcfg, tcfg, jp = _llama()
    tp = convert.from_jax_params(jax_to_numpy(jp), device="cpu")
    ids = _ids(b=3, t=8, seed=5)
    layers = ["layers.0.q_proj", "layers.1.down_proj", "layers.1.o_proj"]
    for kw in ({}, {"layers": layers}):
        ref = jcal.calibrate(jp, jcfg, jnp.asarray(ids), use_abs=use_abs,
                             batch_size=2, **kw)
        got = calibrate.calibrate(tp, tcfg, ids, use_abs=use_abs,
                                  batch_size=2, device="cpu", **kw)
        assert sorted(got) == sorted(ref)
        assert len(got) == (len(layers) if kw else 14)
        for name, v in ref.items():
            assert got[name].dtype == torch.float32
            assert_close_max(got[name], np.asarray(v), 1e-6)


def test_calibrate_other_forward():
    jfwd, tfwd, jcfg, tcfg, jp = _opt()
    ids = _ids(b=2, t=6, seed=6)
    ref = jcal.calibrate(jp, jcfg, jnp.asarray(ids), forward_fn=jfwd)
    got = calibrate.calibrate(
        convert.from_jax_params(jax_to_numpy(jp), device="cpu"), tcfg, ids,
        forward_fn=tfwd, device="cpu")
    assert sorted(got) == sorted(ref)
    for name, v in ref.items():
        assert_close_max(got[name], np.asarray(v), 1e-6)


def test_calibration_files_cross(tmp_path):
    _, _, jcfg, tcfg, jp = _llama()
    tp = convert.from_jax_params(jax_to_numpy(jp), device="cpu")
    ids = _ids(b=1, t=8, seed=7)
    jacts = jcal.calibrate(jp, jcfg, jnp.asarray(ids))
    tacts = calibrate.calibrate(tp, tcfg, ids, device="cpu")
    jcal.save_calibration(jacts, str(tmp_path / "jax.npz"))
    calibrate.save_calibration(tacts, str(tmp_path / "port.npz"))
    from_jax = calibrate.load_calibration(str(tmp_path / "jax.npz"))
    from_port = jcal.load_calibration(str(tmp_path / "port.npz"))
    assert sorted(from_jax) == sorted(tacts) == sorted(from_port)
    for name, v in tacts.items():
        np.testing.assert_array_equal(from_jax[name], np.asarray(jacts[name]))
        np.testing.assert_array_equal(from_port[name], v.numpy())
    # a loaded file drives quantize_model as the dict it was
    q = api.quantize_model(tp, fmt="any4", group_size=64, init="int",
                           kmeans_iters=2, sample_weight=from_port,
                           device="cpu")
    q2 = api.quantize_model(tp, fmt="any4", group_size=64, init="int",
                            kmeans_iters=2, sample_weight=tacts,
                            device="cpu")
    assert torch.equal(q["layers"][1]["up_proj"].lut,
                       q2["layers"][1]["up_proj"].lut)


def test_quantize_model_calibrate_fn():
    jfwd, tfwd, jcfg, tcfg, jp = _llama()
    tp = convert.from_jax_params(jax_to_numpy(jp), device="cpu")
    ids = _ids(b=2, t=8, seed=8)
    kw = dict(fmt="any4", group_size=64, init="int", kmeans_iters=4)
    jq = japi.quantize_model(jp, calibrate_fn=jcal.make_calibrate_fn(
        jp, jcfg, jnp.asarray(ids)), **kw)
    tq = api.quantize_model(tp, calibrate_fn=calibrate.make_calibrate_fn(
        tp, tcfg, ids, device="cpu"), device="cpu", **kw)
    offline = api.quantize_model(tp, sample_weight=calibrate.calibrate(
        tp, tcfg, ids, device="cpu"), device="cpu", **kw)
    n = 0
    for jl, tl, ol in zip(jq["layers"], tq["layers"], offline["layers"]):
        for key, qt in tl.items():
            if not hasattr(qt, "lut"):
                continue
            ref = convert.qt_from_jax(jax_to_numpy(jl[key]), device="cpu")
            assert qt.fmt == ref.fmt
            assert torch.equal(qt.packed, ref.packed), key
            np.testing.assert_allclose(qt.lut.numpy(), ref.lut.numpy(),
                                       atol=1e-5, rtol=0)
            assert torch.equal(qt.packed, ol[key].packed)
            assert torch.equal(qt.lut, ol[key].lut)
            n += 1
    assert n == 14
