"""The plain reference against the port at tiny sizes on the CPU, for every
configuration of ``BENCHMARK.json`` at its architecture's ``tiny`` sizes:
the same dequantized weights from the same drawn fields, logits within
bf16's reach of the port's forward, and a routed layer's feed-forward
equal to the port's in float32; and the control (fp8 activations) comes
out not correct where the program comes out correct, in every cell."""
import dataclasses
import json
import os
import time

import pytest
import torch

from portbench import archs, build, inputs, program, run, spec
from portbench.reference.model import Reference

from conftest import REPO, TINY_LIMITS

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
CONFIGS = [c["name"] for c in BENCH["configs"]]
CELLS = [w["name"] for w in BENCH["workloads"]]


def _config(root, name):
    return json.load(open(f"{root}/portbench/configs/{name}.json"))


def _routed_layer(cfg):
    """The first layer of ``cfg`` with routed experts, or None."""
    arch = archs.of(cfg)
    return next((li for li in range(cfg["num_hidden_layers"])
                 if arch.experts(cfg, li)), None)


def _f32_routed():
    """The configurations whose tiny float32 sizes route some layer."""
    out = []
    for name in CONFIGS:
        cfg = _config(REPO, name)
        cfg.update(archs.of(cfg).tiny(cfg, f32=True))
        if _routed_layer(cfg) is not None:
            out.append(name)
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_dequantizes_as_the_port(tiny_root, name):
    from any4_tpu_torch.ops import linear as lin
    cfg = _config(tiny_root, name)
    fields, _ = inputs.draw_layer(cfg, 5, 0, "cpu")
    for f in fields.values():
        qt = program.pack(cfg, f)
        assert torch.equal(inputs.dequantize(cfg, f),
                           lin.dequantize_tensor(qt, torch.float32))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", (3, 2**31 + 5))
def test_reference_matches_the_port_forward(tiny_root, name, seed):
    from any4_tpu_torch.models import generate
    cfg = _config(tiny_root, name)
    ids = torch.as_tensor(inputs.synthetic_stream(512, 48, seed)).long()
    params = program.build_params(cfg, seed, "cpu")
    mc = program.model_config(cfg)
    got, _ = generate._model_forward(params)(params, mc, ids[None])
    ref = Reference(cfg, seed, "cpu")
    want = ref.hidden([ids])[0] @ ref.head().t()
    # bf16 activations, and x rounded to bf16 at every quantized linear
    tol = 3e-2 * float(want.abs().max())
    assert float((got[0].float() - want).abs().max()) <= tol


@pytest.mark.parametrize("name", _f32_routed())
def test_reference_routes_as_the_port(name):
    """The reference's routed feed-forward against the port's on the first
    routed layer at the architecture's float32 tiny sizes (2 of 4 experts
    for Mixtral), both in float32 on the same weights."""
    cfg = _config(REPO, name)
    cfg.update(archs.of(cfg).tiny(cfg, f32=True))
    li = _routed_layer(cfg)
    fields, dense = inputs.draw_layer(cfg, 9, li, "cpu")
    w = {n: inputs.dequantize(cfg, f) for n, f in fields.items()}
    w.update((n, t.float()) for n, t in dense.items())
    d = cfg["hidden_size"]
    port = build.of(cfg)
    layer = port.layer(cfg, li, {n: w[n] for n in fields},
                       {n: w[n] for n in dense}, torch.ones(d))
    mc = dataclasses.replace(program.model_config(cfg),
                             dtype=torch.float32)
    h = torch.randn(1, 64, d, generator=torch.Generator().manual_seed(0))
    got = port.ffn(layer, mc, h)[0]
    ref = Reference(cfg, 9, "cpu")
    want, margin = archs.of(cfg).ffn(ref, h[0], w, li)
    assert bool(torch.isfinite(margin).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    """The fp8-activation control at the same positions, put in the
    program's place and judged by the cell's limits, comes out not correct
    on three seeds."""
    c = spec.load_cell(cell, tiny_root)
    for name, v in c.limits.items():
        assert v["limit"] == TINY_LIMITS[name]
    for seed in (11, 12, 2**31 + 13):
        r = run.run_cell(c, seed, 1.0, False, "cpu", time.perf_counter(),
                         control=True)
        assert r["correct"] and not r["control_correct"], (seed, r)
        assert set(r["control_checks"]) == set(c.limits)
        assert r["control_checks"] == run.judge(r["control"], c.limits,
                                                0)[1]
