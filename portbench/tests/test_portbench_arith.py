"""The roofline, mfu and trace arithmetic on hand-computed shapes."""
import math
from types import SimpleNamespace

from portbench import trace
from portbench.metrics import _arith
from portbench.record import Run, Step, Trace

DENSE = {"model_type": "llama", "hidden_size": 4096, "intermediate_size": 14336,
         "num_hidden_layers": 2, "num_attention_heads": 32,
         "num_key_value_heads": 8, "vocab_size": 32768,
         "quantization": {"group_size": 128}}
MOE = dict(DENSE, model_type="mixtral", num_local_experts=8,
           num_experts_per_tok=2)


def test_weight_bytes():
    # codes n k / 2, f32 scales and zeros a group, a 16-entry f32 table a row
    assert _arith.weight_bytes(4096, 4096, 128) == (
        4096 * 4096 // 2 + 2 * 4 * 4096 * 32 + 16 * 4 * 4096)


def test_dense_layer_at_one_token_is_bound_by_bytes():
    # q 4096x4096, k and v 1024x4096, o 4096x4096, gate/up 14336x4096,
    # down 4096x14336
    shapes = [(4096, 4096), (1024, 4096), (1024, 4096), (4096, 4096),
              (14336, 4096), (14336, 4096), (4096, 14336)]
    want = sum((_arith.weight_bytes(n, k, 128) + 2 * (n + k)) / 3.35e12
               for n, k in shapes)
    assert math.isclose(_arith.layer_linear_seconds(DENSE, 0, 1), want)


def test_dense_layer_at_many_tokens_is_bound_by_flops():
    m = 4096
    flops = 2 * m * 4096 * (4096 * 2 + 1024 * 2 + 14336 * 3)
    assert math.isclose(_arith.layer_linear_seconds(DENSE, 1, m) * 989e12,
                        flops, rel_tol=1e-9)


def test_experts_routed_under_uniform_routing():
    m = 16
    routed = 8 * (1 - (1 - 2 / 8) ** m)
    assert 7.9 < routed < 7.93
    attn = sum((_arith.weight_bytes(n, k, 128) + 2 * m * (n + k)) / 3.35e12
               for n, k in [(4096, 4096), (1024, 4096), (1024, 4096),
                            (4096, 4096)])
    expert_w = 2 * _arith.weight_bytes(14336, 4096, 128) + \
        _arith.weight_bytes(4096, 14336, 128)
    acts = 2 * m * 2 * 3 * (4096 + 14336)
    moe = max(2 * m * 2 * 3 * 14336 * 4096 / 989e12,
              (routed * expert_w + acts) / 3.35e12)
    assert math.isclose(_arith.layer_linear_seconds(MOE, 0, m), attn + moe)


def test_token_and_attention_flops():
    lin = 2 * 4096 * (4096 * 2 + 1024 * 2 + 14336 * 3)
    assert _arith.token_flops(DENSE) == 2 * lin + 2 * 4096 * 32768
    moe_lin = 2 * 4096 * (4096 * 2 + 1024 * 2) + 2 * 3 * 14336 * 4096 * 2 \
        + 2 * 4096 * 8
    assert _arith.token_flops(MOE) == 2 * moe_lin + 2 * 4096 * 32768
    assert _arith.attention_flops(DENSE, 10) == 4 * 32 * 128 * 10 * 2


def test_step_flops_count_causal_prefill_and_true_contexts():
    s = Step(0, 1, "admit", prefill=[3], decode_ctx=[5, 7])
    tf = _arith.token_flops(DENSE)
    want = 3 * tf + _arith.attention_flops(DENSE, 6) + 2 * tf \
        + _arith.attention_flops(DENSE, 12)
    assert math.isclose(_arith.step_flops(DENSE, s), want)


def _run(steps, tr):
    return Run(DENSE, {}, {"quantized_linear": ["q4_post_mma"],
                           "decode_attention": ["decode_kernel"]},
               steps, (0.0, 4.0), tr)


def test_roofline_and_idle_share():
    steps = [Step(0.0, 2.0, "decode", decode_ctx=[4] * 8),
             Step(2.0, 4.0, "decode", decode_ctx=[5] * 8, traced=True)]
    tr = Trace(2.0, 0.5, {"void q4_post_mma<1>(x)": 0.004,
                          "decode_kernel<2>": 0.001, "elementwise": 0.1},
               {})
    run = _run(steps, tr)
    bound = 2 * _arith.layer_linear_seconds(DENSE, 0, 8)
    assert math.isclose(_arith.roofline_pct(run), 100 * bound / 0.004)
    assert math.isclose(_arith.idle_pct(run), 75.0)
    assert math.isclose(run.untraced_seconds(), 2.0)
    assert math.isclose(_arith.mfu_pct(run), 100 * _arith.step_flops(
        DENSE, steps[0]) / (2.0 * 989e12))


def _ev(name, s, e, cuda):
    from torch.autograd import DeviceType
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=s, end=e), device_type=DeviceType.CUDA if cuda
        else DeviceType.CPU)


def test_trace_union_and_idle_by_span():
    evs = [_ev("portbench.decode", 0, 100, False),
           _ev("portbench.client", 100, 150, False),
           _ev("k1", 10, 40, True), _ev("k2", 30, 60, True),
           _ev("k1", 120, 130, True), _ev("aten::mm", 5, 6, False)]
    t = trace.reduce(evs)
    assert math.isclose(t.window_s, 150e-6)
    assert math.isclose(t.busy_s, 60e-6)
    assert math.isclose(t.kernels["k1"], 40e-6)
    # gaps: 0-10 and 60-100 in decode, 100-120 and 130-150 in client
    assert math.isclose(t.idle["portbench.decode"], 50e-6)
    assert math.isclose(t.idle["portbench.client"], 40e-6)
    b = trace.breakdown(t)
    assert b["device_ops"][0][0] == "k1"
