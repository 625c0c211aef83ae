"""The port's AWQ (``any4_tpu_torch.quant.awq``) against the JAX package, on
the CPU, at tiny sizes (g=32, grids of 4-8 ratios).

Inputs are made by numpy from a seed; models by the JAX package, carried
across with ``convert.from_jax_params``. Bars:
- ``pseudo_quantize`` bit-exact for int/nf4/fp4 (the same IEEE ops), any4
  within 1e-6 * max (JAX's k-means sums in another order);
- the scale and clip searches: MSEs within 1e-5 relative and the same grid
  index, where either of two MSEs within 1e-6 relative of each other is
  accepted (a tie); the searches are fed the same ``x_max``, since a mean
  summed in another order moves a scale by an ulp;
- ``run_awq`` on float32 Llama (GQA, rep 2), OPT and Mixtral: the same
  ratios and clip ratios, scales and scaled weights within 1e-5 * max,
  logits output-neutral within 1e-4 * max in float32 (clip off);
  ``apply_awq`` reproduces the scaled tree bit for bit, and artifacts
  saved by either package apply in the other;
- the slice as a whole (``run_awq`` -> ``calibrate`` -> any4 with the int
  init -> greedy tokens) by ``test_torch_engine.py``'s tie rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu import calibrate as jcal
from any4_tpu.models import generate as jgen
from any4_tpu.models import llama as jllama
from any4_tpu.models import mixtral as jmixtral
from any4_tpu.models import opt as jopt
from any4_tpu.quant import api as japi
from any4_tpu.quant import awq as jawq
from any4_tpu_torch import calibrate, convert
from any4_tpu_torch.models import generate, llama, mixtral, opt
from any4_tpu_torch.quant import api, awq
from test_torch_convert import assert_close_max, jax_to_numpy
from test_torch_engine import QUANT_TIE

TIE = 1e-6


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _acts(t, k, seed, outliers=3):
    """Activations with a few channels scaled up, as AWQ expects them."""
    x = _w((t, k), seed)
    x[:, :outliers] *= np.float32(20.0)
    return x


def _same_choice(port, ref):
    """The two MSE grids agree within 1e-5 relative and pick the same
    index, or indices whose MSEs are within TIE of each other."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=0)
    i, j = int(np.argmin(port)), int(np.argmin(ref))
    assert i == j or abs(ref[i] - ref[j]) <= TIE * ref[j], (i, j, ref)


@pytest.mark.parametrize("numeric_type", ["int", "nf4", "fp4", "any4"])
def test_pseudo_quantize_matches_jax(numeric_type):
    w = _w((16, 128), 1)
    ref = np.asarray(jawq.pseudo_quantize(jnp.asarray(w), 4, 32,
                                          numeric_type))
    out = awq.pseudo_quantize(torch.from_numpy(w), 4, 32, numeric_type)
    if numeric_type == "any4":
        assert_close_max(out, ref, 1e-6)
    else:
        np.testing.assert_array_equal(out.numpy(), ref)


def test_pseudo_quantize_keeps_dtype():
    w = torch.from_numpy(_w((8, 64), 2)).to(torch.bfloat16)
    assert awq.pseudo_quantize(w, group_size=32).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="numeric_type"):
        awq.pseudo_quantize(w, numeric_type="int3")


@pytest.mark.parametrize("seed", range(8))
def test_scale_search_matches_jax(seed):
    x = _acts(48, 128, seed)
    ws = [_w((32, 128), seed + 100), _w((16, 128), seed + 200)]
    x_max = np.abs(x).mean(axis=0).astype(np.float32) + np.float32(1e-8)
    ref = jawq._scale_search_mses(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                                  jnp.asarray(x_max), 8, 4, 32, "int")
    out = awq._scale_search_mses(torch.from_numpy(x),
                                 [torch.from_numpy(w) for w in ws],
                                 torch.from_numpy(x_max), 8, 4, 32, "int")
    _same_choice(out.numpy(), ref)
    # the winner's scale, from the Python ratio, as JAX builds it
    ratio = int(np.argmin(np.asarray(ref))) / 8
    assert_close_max(awq._candidate_scale(torch.from_numpy(x_max), ratio),
                     jawq._candidate_scale(jnp.asarray(x_max), ratio), 1e-6)


@pytest.mark.parametrize("seed", range(8))
def test_clip_search_matches_jax(seed):
    x = _acts(48, 128, seed)
    w = _w((32, 128), seed + 300)
    w[0, 0] = 12.0              # an outlier that hurts its group's scale
    ref = jawq._clip_search_mses(jnp.asarray(x), jnp.asarray(w), 6, 0.5, 4,
                                 32, "int")
    out = awq._clip_search_mses(torch.from_numpy(x), torch.from_numpy(w), 6,
                                0.5, 4, 32, "int")
    _same_choice(out.numpy(), ref)


@pytest.mark.parametrize("numeric_type", ["int", "any4"])
def test_search_results_match_jax(numeric_type):
    """The public searches: the ratio chosen, the scales and the clipped
    weight."""
    x = _acts(40, 64, 9)
    w = _w((24, 64), 10)
    s_ref, r_ref = jawq.search_scale(jnp.asarray(x), [jnp.asarray(w)],
                                     n_grid=6, group_size=32,
                                     numeric_type=numeric_type)
    s, r = awq.search_scale(torch.from_numpy(x), [torch.from_numpy(w)],
                            n_grid=6, group_size=32,
                            numeric_type=numeric_type)
    assert r == r_ref
    assert_close_max(s, s_ref, 1e-5)
    c_ref, cr_ref = jawq.search_clip(jnp.asarray(x), jnp.asarray(w),
                                     n_grid=5, group_size=32,
                                     return_ratio=True,
                                     numeric_type=numeric_type)
    c, cr = awq.search_clip(torch.from_numpy(x), torch.from_numpy(w),
                            n_grid=5, group_size=32, return_ratio=True,
                            numeric_type=numeric_type)
    assert cr == cr_ref
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


MODELS = {
    "llama": (jllama, llama, lambda m: m.LlamaConfig.tiny(vocab=128,
                                                          layers=2)),
    "opt": (jopt, opt, lambda m: m.OPTConfig.tiny(vocab=128)),
    "mixtral": (jmixtral, mixtral,
                lambda m: m.MixtralConfig.tiny(vocab=128, layers=1)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def searched(request):
    """A float32 tiny model of each family searched by both packages (g=32,
    8 ratios, clip on)."""
    jmod, tmod, make = MODELS[request.param]
    jcfg = dataclasses.replace(make(jmod), dtype=jnp.float32)
    tcfg = dataclasses.replace(make(tmod), dtype=torch.float32)
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.from_jax_params(jax_to_numpy(jp), device="cpu")
    ids = np.random.default_rng(1).integers(0, 128, (2, 12)).astype(np.int32)
    jres, jscaled = jawq.run_awq(jp, jcfg, jnp.asarray(ids), group_size=32,
                                 n_grid=8)
    tres, tscaled = awq.run_awq(tp, tcfg, torch.from_numpy(ids),
                                group_size=32, n_grid=8, device="cpu")
    return dict(name=request.param, jmod=jmod, tmod=tmod, jcfg=jcfg,
                tcfg=tcfg, jp=jp, tp=tp, ids=ids, jres=jres,
                jscaled=jscaled, tres=tres, tscaled=tscaled)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def test_run_awq_matches_jax(searched):
    jres, tres = searched["jres"], searched["tres"]
    n_layers = searched["tcfg"].num_hidden_layers
    groups = (3 + searched["tcfg"].num_local_experts
              if searched["name"] == "mixtral" else 4)
    assert len(tres["scales"]) == groups * n_layers
    assert tres["scales"].keys() == jres["scales"].keys()
    for key, ref in jres["scales"].items():
        got = tres["scales"][key]
        assert got["ratio"] == ref["ratio"], key
        assert got["targets"] == ref["targets"]
        for f in ("scales", "scales_prev"):
            assert isinstance(got[f], np.ndarray)
            assert_close_max(got[f], ref[f], 1e-5)
    assert tres["clip"] == jres["clip"]
    ref = dict(_leaves(jax_to_numpy(searched["jscaled"])))
    got = dict(_leaves(searched["tscaled"]))
    assert got.keys() == ref.keys()
    for name, leaf in got.items():
        assert_close_max(leaf, ref[name], 1e-5)
    # the input tree is left as it was
    for name, leaf in _leaves(searched["tp"]):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(
            dict(_leaves(jax_to_numpy(searched["jp"])))[name]))


def test_run_awq_output_neutral(searched):
    tmod, tcfg, tp = searched["tmod"], searched["tcfg"], searched["tp"]
    ids = torch.from_numpy(searched["ids"])
    unclipped = awq.apply_awq(tp, searched["tres"], do_clip=False,
                              device="cpu")
    assert_close_max(tmod.forward(unclipped, tcfg, ids)[0],
                     tmod.forward(tp, tcfg, ids)[0], 1e-4)


def test_apply_awq_reproduces(searched):
    replayed = awq.apply_awq(searched["tp"], searched["tres"], device="cpu")
    got = dict(_leaves(replayed))
    for name, leaf in _leaves(searched["tscaled"]):
        assert torch.equal(got[name], leaf), name


def test_artifacts_cross(searched, tmp_path):
    """A JAX artifact applies in the port as JAX applies it, and the
    port's in JAX as the port applies it."""
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jawq.save_awq(jpath, searched["jres"])
    awq.save_awq(tpath, searched["tres"])
    assert awq.load_awq(tpath)["clip"] == searched["tres"]["clip"]
    port = awq.apply_awq(searched["tp"], awq.load_awq(jpath), device="cpu")
    ref = dict(_leaves(jax_to_numpy(jawq.apply_awq(searched["jp"],
                                                   searched["jres"]))))
    for name, leaf in _leaves(port):
        assert_close_max(leaf, ref[name], 1e-6)
    back = dict(_leaves(jax_to_numpy(jawq.apply_awq(searched["jp"],
                                                    jawq.load_awq(tpath)))))
    for name, leaf in _leaves(searched["tscaled"]):
        assert_close_max(leaf, back[name], 1e-6)


def test_apply_awq_default_targets():
    """An artifact without ``targets`` uses each producer's default group
    (OPT's v_proj feeds out_proj)."""
    cfg = dataclasses.replace(opt.OPTConfig.tiny(vocab=64, layers=1),
                              dtype=torch.float32)
    params = opt.init_params(cfg, seed=0, device="cpu")
    s = np.linspace(0.5, 2.0, 64).astype(np.float32)
    res = {"scales": {"layers.0.v_proj": {"ratio": 0.5, "scales": s,
                                          "scales_prev": s}}}
    out = awq.apply_awq(params, res, device="cpu")["layers"][0]
    layer = params["layers"][0]
    torch.testing.assert_close(out["out_proj"],
                               layer["out_proj"] * torch.from_numpy(s))
    torch.testing.assert_close(out["v_proj"],
                               layer["v_proj"] / torch.from_numpy(s)[:, None])


def test_awq_pipeline_matches_jax():
    """The slice as a whole: run_awq -> calibrate -> any4 (int init) ->
    greedy tokens, in both packages, held by the tie rule."""
    # the shapes of the searched fixture's Llama, whose compiled JAX
    # searches this reuses
    jmod, tmod, make = MODELS["llama"]
    jcfg = dataclasses.replace(make(jmod), dtype=jnp.float32)
    tcfg = dataclasses.replace(make(tmod), dtype=torch.float32)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tp = convert.from_jax_params(jax_to_numpy(jp), device="cpu")
    ids = np.random.default_rng(4).integers(0, 128, (2, 12)).astype(np.int32)
    _, jscaled = jawq.run_awq(jp, jcfg, jnp.asarray(ids), group_size=32,
                              n_grid=8)
    jq = japi.quantize_model(jscaled, fmt="any4", group_size=32, init="int",
                             kmeans_iters=5, sample_weight=jcal.calibrate(
                                 jscaled, jcfg, jnp.asarray(ids)))
    _, tscaled = awq.run_awq(tp, tcfg, torch.from_numpy(ids), group_size=32,
                             n_grid=8, device="cpu")
    tq = api.quantize_model(tscaled, fmt="any4", group_size=32, init="int",
                            kmeans_iters=5, device="cpu",
                            sample_weight=calibrate.calibrate(
                                tscaled, tcfg, ids, device="cpu"))
    prompt = ids[:1, :6]
    want = np.asarray(jgen.generate(jq, jcfg, jnp.asarray(prompt),
                                    max_new_tokens=6))
    got = generate.generate(tq, tcfg, torch.from_numpy(prompt),
                            max_new_tokens=6, device="cpu").numpy()
    # teacher-forced logits of both along JAX's tokens
    seq = np.array(want[:, :-1])
    ref = np.asarray(jllama.forward(jq, jcfg, jnp.asarray(seq))[0],
                     np.float32)[0, 5:]
    port = llama.forward(tq, tcfg, torch.from_numpy(seq))[0].float().numpy(
    )[0, 5:]
    span = QUANT_TIE * np.abs(ref).max(axis=-1)
    assert (np.abs(port - ref).max(axis=-1) <= span).all()
    for i, (g, w) in enumerate(zip(got[0, 6:], want[0, 6:])):
        top = np.sort(ref[i])[::-1]
        if top[0] - top[1] < span[i]:
            assert ref[i][g] >= top[0] - span[i]
            break
        assert g == w


def test_run_awq_checks_device():
    cfg = llama.LlamaConfig.tiny(vocab=64, layers=1)
    params = llama.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="params are on"):
        awq.run_awq(params, cfg, np.zeros((1, 4), np.int32), device="meta")
