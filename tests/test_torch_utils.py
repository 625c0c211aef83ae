"""The port's ``utils.py`` and ``profiler.py`` against the JAX package's, on
the CPU, at tiny sizes.

- ``assert_close``: JAX's verdict and message on seeded cases, for arrays
  and for tensors;
- the benchmark helpers call the function the stated number of times and
  refuse an output that names no device;
- ``utils`` imports no other module of the port;
- ``get_model_size``: JAX's on the same dense tree; on the same any4 g=128
  tree it differs only by the layouts' padding, computed here;
- ``profile_decode_components``: JAX's keys and its ``max_layers``
  extrapolation (as ``tests/test_profiler_analyze.py`` checks JAX's).
"""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from any4_tpu import utils as jutils
from any4_tpu.models import checkpoint as jcheckpoint
from any4_tpu.models import llama as jllama
from any4_tpu.profiler import profile_decode_components
from any4_tpu.quant import api as japi
from any4_tpu_torch import convert, profiler, utils
from any4_tpu_torch.models import checkpoint, llama
from any4_tpu_torch.quant import api
from any4_tpu_torch.ops import linear as tlin
from any4_tpu_torch.ops import packing
from test_torch_convert import jax_to_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch for this file's tests: in the parallel test
    run the workers already fill the cores, and torch's intra-op threads
    then spin against them on these tiny shapes (one CPU benchmark run
    went from 2 s to 120 s on a loaded machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_case(name):
    rng = np.random.default_rng(3)
    e = rng.standard_normal(64).astype(np.float32)
    a = e + np.float32(1e-4)
    kw = dict(allowed_violations=2)
    if name == "within_allowed":
        a[[3, 7]] += np.float32(0.05)
    elif name == "too_many":
        a[:5] += np.float32(0.05)
    elif name == "past_factor":
        a[9] += np.float32(1.0)
    return a, e, kw


def _verdict(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except AssertionError as err:
        return str(err)
    return None


@pytest.mark.parametrize("name", ["clean", "within_allowed", "too_many",
                                  "past_factor"])
def test_assert_close_matches_jax(name):
    a, e, kw = _close_case(name)
    ref = _verdict(jutils.assert_close, a, e, **kw)
    assert (ref is None) == (name in ("clean", "within_allowed"))
    assert _verdict(utils.assert_close, a, e, **kw) == ref
    assert _verdict(utils.assert_close, torch.from_numpy(a),
                    torch.from_numpy(e), **kw) == ref


def test_benchmark_helpers_call_counts():
    calls = []

    def f(x, scale=1.0):
        calls.append(1)
        return x * scale

    x = torch.ones(4)
    assert utils.benchmark_in_ms(f, x, warmup=2, iters=5, scale=2.0) >= 0
    assert len(calls) == 7
    calls.clear()
    assert utils.benchmark_best_in_ms(f, x, iters=3, rounds=2) >= 0
    assert len(calls) == 1 + 2 * 3
    counts = {"a": 0, "b": 0}

    def g(key):
        counts[key] += 1
        return (torch.zeros(1), 0)

    ms = utils.best_in_ms({k: (lambda k=k: g(k)) for k in counts},
                          iters=4, rounds=3)
    assert set(ms) == {"a", "b"} and counts == {"a": 13, "b": 13}


def test_benchmark_needs_a_tensor_output():
    with pytest.raises(ValueError, match="CUDA tensors or CPU tensors"):
        utils.benchmark_best_in_ms(lambda: 1.0, iters=1, rounds=1)
    with pytest.raises(ValueError, match="warmup"):
        utils.benchmark_in_ms(lambda: torch.zeros(1), warmup=0)


@pytest.fixture(scope="module")
def tiny_jax():
    cfg = jllama.LlamaConfig.tiny(vocab=256, layers=2)
    return cfg, jllama.init_params(cfg, jax.random.PRNGKey(0))


def test_get_model_size_dense_matches_jax(tiny_jax):
    _, jp = tiny_jax
    tp = convert.from_jax_params(jax_to_numpy(jp), device="cpu")
    assert utils.get_model_size(tp) == japi.model_size_bytes(jp) > 0


def test_get_model_size_any4_matches_jax_up_to_padding(tiny_port, tmp_path):
    """The same any4 g=128 weights in both layouts: quantized by the port,
    carried to JAX's QuantizedTensors through the shared checkpoint."""
    cfg, params = tiny_port
    tq = api.quantize_model(params, fmt="any4", group_size=128,
                            kmeans_iters=1, device="cpu")
    checkpoint.save_params(str(tmp_path), tq, cfg)
    jq, _ = jcheckpoint.load_params(str(tmp_path))
    padding = 0
    leaves = [(jl[key], lt) for jl, tl in zip(jq["layers"], tq["layers"])
              for key, lt in tl.items()
              if isinstance(lt, tlin.QuantizedTensor)]
    assert len(leaves) == 14
    for lj, lt in leaves:
        n, k = lt.shape
        kp = packing.padded_k(k)
        # the port's layout: [n, kp/8] int32 codes, [kp/g, n] f32 scales and
        # zeros, a [n, 16] f32 LUT
        port = n * kp // 2 + 2 * 4 * (kp // lt.group_size) * n + 64 * n
        assert lt.nbytes == port
        padding += port - lj.nbytes
    assert utils.get_model_size(tq) == japi.model_size_bytes(jq) + padding


def test_utils_loads_no_other_module_of_the_port():
    """``utils`` is a leaf: importing it (as ``chip_smoke`` does for
    ``Timer``) loads no other module of the port, the quantizer included."""
    code = ("import sys, any4_tpu_torch.utils; print(sorted(m for m in "
            "sys.modules if m.startswith('any4_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "['any4_tpu_torch', 'any4_tpu_torch.utils']"


def test_device_memory_stats():
    assert utils.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no memory statistics"):
            utils.device_memory_stats()


@pytest.fixture(scope="module")
def tiny_port():
    cfg = llama.LlamaConfig.tiny(vocab=256, layers=2)
    return cfg, llama.init_params(cfg, seed=0, device="cpu")


def test_profiler_keys_match_jax(tiny_jax, tiny_port):
    ref = profile_decode_components(tiny_jax[1], tiny_jax[0], ctx=64,
                                    iters=1, rounds=1)
    prof = profiler.profile_decode_components(tiny_port[1], tiny_port[0],
                                              ctx=64, iters=3, rounds=2)
    assert set(prof) == set(ref) == {"layers.0", "layers.1", "totals"}
    assert set(prof["totals"]) == set(ref["totals"])
    for k in ("layers.0", "layers.1"):
        assert set(prof[k]) == set(ref[k])
        assert prof[k]["attention_ms"] > 0
        assert prof[k]["mlp_ms"] > 0
    assert 0.0 <= prof["totals"]["attention_share"] <= 1.0
    assert prof["totals"]["layers_profiled"] == 2


def test_profiler_max_layers_extrapolates(tiny_port):
    cfg, params = tiny_port
    prof = profiler.profile_decode_components(params, cfg, ctx=64, iters=2,
                                              rounds=1, max_layers=1)
    assert prof["totals"]["layers_profiled"] == 1
    assert "layers.1" not in prof
    att, mlp = prof["layers.0"]["attention_ms"], prof["layers.0"]["mlp_ms"]
    tot = prof["totals"]
    assert tot["attention_ms"] == pytest.approx(2 * att)
    assert tot["mlp_ms"] == pytest.approx(2 * mlp)
    assert tot["sum_ms"] == pytest.approx(2 * (att + mlp))
    assert tot["attention_share"] == pytest.approx(att / (att + mlp))
