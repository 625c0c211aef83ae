"""The port stands alone: importing any of its modules loads neither JAX
nor the JAX package, and every entry point runs on the GPU unless asked."""
import ast
import inspect
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import any4_tpu_torch
from any4_tpu_torch import calibrate, convert, utils
from any4_tpu_torch.cli import microbenchmark
from any4_tpu_torch.models import (checkpoint, generate, llama, loader,
                                   mixtral, opt)
from any4_tpu_torch.quant import api, awq
from any4_tpu_torch.serving import engine, kv_cache

PKG_DIR = os.path.dirname(any4_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    return ["any4_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG_DIR], "any4_tpu_torch.")]


def test_import_loads_no_jax():
    code = ("import importlib, json, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'any4_tpu'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_model_modules_import_without_hf_packages():
    """The loader and the Mixtral and OPT models import where neither
    safetensors nor transformers can be imported; only the functions that
    read shards or build HF models need them."""
    code = ("import json, sys\n"
            "sys.modules['safetensors'] = None\n"
            "sys.modules['transformers'] = None\n"
            "from any4_tpu_torch.models import loader, mixtral, opt\n"
            "cfg = loader._mixtral_cfg_from_hf(dict(vocab_size=8, "
            "hidden_size=4, intermediate_size=8, num_hidden_layers=1, "
            "num_attention_heads=1))\n"
            "print(json.dumps([type(cfg).__name__, sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('safetensors', "
            "'transformers') and sys.modules[m] is not None)]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        "MixtralConfig", []]


def _sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(PKG_DIR):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_sources_import_no_jax():
    """Neither the port nor ``chip_smoke.py`` imports JAX, the JAX package
    or scikit-learn (the GPU machine has scipy, not scikit-learn)."""
    bad = []
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "any4_tpu",
                                           "flax", "optax", "sklearn")]
    assert bad == []


def test_sources_import_no_top_level_script():
    """The port's scripts keep their own copies (``cli/common.py``'s
    ``parse_kv_args``): no module of the port imports the JAX package's
    top-level scripts."""
    scripts = {os.path.splitext(f)[0] for f in os.listdir(REPO)
               if f.endswith(".py")}
    assert {"cli_eval", "cli_quantize", "bench", "example"} <= scripts
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in scripts
                    and n.split(".")[0] != "chip_smoke"]
    assert bad == []


@pytest.mark.parametrize("fn", [llama.init_params, api.quantize_model,
                                generate.generate, checkpoint.load_params,
                                convert.from_jax_params,
                                convert.tensor_from_numpy,
                                convert.qt_from_jax,
                                kv_cache.PagedKVCache.create,
                                engine.Engine.__init__,
                                api.quant_methods["int4"],
                                api.quant_methods["w4a8"],
                                api.quant_methods["int8"],
                                api.quant_methods["w8a8"],
                                api.quant_methods["any4q8"],
                                api.quant_methods["mx4"],
                                api.quant_methods["int8p"],
                                api.quant_methods["int8r"],
                                api.quant_methods["w8a8r"],
                                api.quant_methods["any4q8r"],
                                mixtral.init_params, opt.init_params,
                                opt.load_hf_opt, loader.load_model,
                                loader.load_llama, loader.load_mixtral,
                                loader.convert_torch_llama,
                                loader.convert_torch_mixtral,
                                loader.convert_torch_opt,
                                loader.load_hf_torch_model,
                                awq.run_awq, awq.apply_awq,
                                calibrate.calibrate,
                                utils.Timer.__init__,
                                utils.device_memory_stats,
                                microbenchmark.sweep,
                                microbenchmark.sweep_operands])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_fails_loudly_without_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        llama.init_params(llama.LlamaConfig.tiny())
