"""The plain reference against the port at tiny sizes on the CPU: the
same dequantized weights from the same drawn fields, and logits within
bf16's reach of the port's forward, for a Llama-shaped (Mistral) and a
Mixtral configuration; and the control (fp8 activations) comes out not
correct where the program comes out correct."""
import dataclasses
import json
import time

import pytest
import torch

from portbench import inputs, program, run, spec
from portbench.reference.model import Reference

from conftest import TINY_LIMITS

CONFIGS = ("mistral7b", "mixtral8x7b")


def _config(root, name):
    return json.load(open(f"{root}/portbench/configs/{name}.json"))


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


def test_reference_routes_as_the_port(tiny_root):
    """The reference's routed FFN against the port's ``moe_ffn`` on one
    layer of 4 experts, top 2, both in float32 on the same weights."""
    from any4_tpu_torch.models import mixtral
    cfg = dict(_config(tiny_root, "mixtral8x7b"), num_local_experts=4)
    fields, router = inputs.draw_layer(cfg, 9, 0, "cpu")
    w = {n: inputs.dequantize(cfg, f) for n, f in fields.items()}
    layer = {"router": router.float(), "experts": [
        {k: w[f"experts.{e}.{k}"] for k in ("w1", "w3", "w2")}
        for e in range(4)]}
    mc = dataclasses.replace(program.model_config(cfg),
                             dtype=torch.float32)
    h = torch.randn(1, 64, 128, generator=torch.Generator().manual_seed(0))
    got = mixtral.moe_ffn(layer, mc, h)[0]
    want = Reference(cfg, 9, "cpu")._moe(h[0], w, router.float())
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("cell", ("mixtral8x7b.chat", "mistral7b.ppl2k",
                                  "mistral7b.rag", "mistral7b.chat"))
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
