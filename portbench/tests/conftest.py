"""Fixtures of the harness's tests: a copy of the benchmark at tiny sizes
(the cells of ``BENCHMARK.json`` with two-layer models of width 128 and
short traffic), run on the CPU through the kernels' plain versions.

Tests that need the card are marked ``card`` and decide inside the
``card`` fixture whether there is one."""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the tiny limits, set from CPU readings at these sizes over 12 seeds: the
# program's widest logit gap 0.029 (the fp8 control 0.26 or more), its
# mean gap 0.00072 (control 0.0136 or more), its mean log-perplexity gap
# 0.00153 (control 0.0026 or more)
TINY_LIMITS = {"logit_gap": 0.08, "logit_gap_mean": 0.004,
               "nll_gap_mean": 0.0021}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


def shrink(root: str) -> None:
    """Cut the copy under ``root`` to tiny sizes, in place: each
    configuration to its architecture's ``tiny``."""
    from portbench import archs
    pb = os.path.join(root, "portbench")
    for f in os.listdir(os.path.join(pb, "configs")):
        p = os.path.join(pb, "configs", f)
        c = json.load(open(p))
        c.update(archs.of(c).tiny(c))
        json.dump(c, open(p, "w"))
    for f in os.listdir(os.path.join(pb, "traffic")):
        p = os.path.join(pb, "traffic", f)
        d = json.load(open(p))
        if d["kind"] == "serve":
            d.update(clients=4, pool=16, queue=256, check_tokens=48,
                     trace_seconds=0.5)
            d["engine"].update(max_slots=4, max_ctx=256)
            d["prompt_len"].update(lo=8, hi=64)
            d["output_len"].update(lo=4, hi=16)
        else:
            d.update(seqlen=256, pool=4, check_windows=4, trace_seconds=0.5)
        json.dump(d, open(p, "w"))
    for f in os.listdir(os.path.join(pb, "limits")):
        p = os.path.join(pb, "limits", f)
        lim = json.load(open(p))
        json.dump({k: {"limit": TINY_LIMITS[k]} for k in lim}, open(p, "w"))


def copy_benchmark(dst: str) -> str:
    """``BENCHMARK.json`` and ``portbench/`` (without tests and caches)
    copied under ``dst``."""
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = copy_benchmark(str(tmp_path_factory.mktemp("tiny")))
    shrink(root)
    return root


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
