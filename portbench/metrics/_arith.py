"""Operations, bytes and peaks for the per-layer readers, counted from a
configuration file and what the run did, never from which kernel ran.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense bf16 989 TFLOP/s
and HBM3 3.35 TB/s, at the full 700 W; a card set below it reads lower.

A quantized linear ``[n, k]`` at group size ``g`` reads, once per forward
or decode step, its 4-bit codes (``n k / 2`` bytes), f32 scales and zeros
(``8 n k / g``) and its per-row f32 table (``64 n``), plus its bf16
activations in and out (``2 m (k + n)``), and does ``2 m n k`` flops for
``m`` tokens. A layer of routed experts does ``2 m K n k`` flops in each
expert linear (``K`` experts a token) and reads the weights of every
expert routed to at least one token: under uniform routing ``E (1 - (1 -
K/E)^m)`` of its ``E`` experts (7.92 of 8 at m = 16, top 2). Which
linears, experts and attention a layer has is its architecture's
(``archs/<model_type>.py``); each layer is counted as it is.
"""
from __future__ import annotations

from portbench import archs, inputs

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def weight_bytes(n: int, k: int, g: int) -> float:
    return n * k / 2 + 8 * n * (k // g) + 64 * n


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def over_layers(config: dict, per_layer) -> float:
    """The sum of ``per_layer(layer)`` over the configuration's layers,
    equal terms added as their count times the term (so a model whose
    layers are all alike reads ``layers * term``)."""
    counts = {}
    for li in range(inputs.hf(config, "num_hidden_layers")):
        v = per_layer(li)
        counts[v] = counts.get(v, 0) + 1
    return sum(n * v for v, n in counts.items())


def layer_linear_seconds(config: dict, layer: int, m: int) -> float:
    """The least time layer ``layer``'s quantized linears could take for
    ``m`` tokens: each linear bounded alone, its routed experts (the
    architecture's ``experts``) as one group."""
    if m <= 0:
        return 0.0
    g = config["quantization"]["group_size"]
    arch = archs.of(config)
    prefix, E, K = arch.experts(config, layer) or (None, 0, 0)
    total, ex_flops, ex_bytes, ex_act = 0.0, 0.0, 0.0, 0.0
    for name, n, k in arch.linears(config, layer):
        if E and name.startswith(prefix):
            ex_flops += 2.0 * m * K * n * k
            ex_bytes += weight_bytes(n, k, g)
            ex_act += 2.0 * m * K * (k + n)
        else:
            total += _bound(2.0 * m * n * k,
                            weight_bytes(n, k, g) + 2.0 * m * (k + n))
    if E:
        routed = E * (1.0 - (1.0 - K / E) ** m)
        # ex_bytes and ex_act summed every expert; keep the routed share
        # of the weights and the K experts' activations once
        total += _bound(ex_flops / E,
                        ex_bytes * routed / E + ex_act / E)
    return total


def step_linear_seconds(config: dict, step) -> float:
    """The quantized linears' least time in one call, layer by layer: each
    prefill's prompt at its true length, then its decode rows together."""
    def per_layer(li):
        s = sum(layer_linear_seconds(config, li, t) for t in step.prefill)
        return s + layer_linear_seconds(config, li, len(step.decode_ctx))
    return over_layers(config, per_layer)


def token_flops(config: dict) -> float:
    """Flops of one token outside attention's context: every linear (the
    top ``K`` of a layer's ``E`` routed experts), the layer's dense leaves
    (a router), and the head."""
    arch = archs.of(config)

    def per_layer(li):
        prefix, E, K = arch.experts(config, li) or (None, 0, 0)
        f = 0.0
        for name, n, k in arch.linears(config, li):
            f += 2.0 * n * k * (K / E if E and name.startswith(prefix)
                                else 1.0)
        return f + arch.extra_flops(config, li)
    hf = inputs.hf
    return (over_layers(config, per_layer)
            + 2.0 * hf(config, "hidden_size") * hf(config, "vocab_size"))


def attention_flops(config: dict, ctx: float) -> float:
    """QK and PV of one token over ``ctx`` positions, every layer."""
    arch = archs.of(config)
    return over_layers(config,
                       lambda li: arch.attention_flops(config, li, ctx))


def step_flops(config: dict, step) -> float:
    """The model's flops in one call: each prefill of ``t`` tokens (causal
    contexts 1..t) and each decode row at its true context."""
    tf = token_flops(config)
    total = 0.0
    for t in step.prefill:
        total += t * tf + attention_flops(config, t * (t + 1) / 2)
    for c in step.decode_ctx:
        total += tf + attention_flops(config, c)
    return total


def mean_ms(steps):
    return (sum(s.t1 - s.t0 for s in steps) * 1e3 / len(steps)
            if steps else None)


def roofline_pct(run) -> float:
    """The quantized linears' least time over the traced steps, as a share
    of the device time of ``kernels/quantized_linear.json``'s kernels."""
    if run.trace is None:
        return None
    t = run.family_seconds("quantized_linear")
    if t <= 0:
        return None
    bound = sum(step_linear_seconds(run.config, s) for s in run.traced())
    return 100.0 * bound / t


def mfu_pct(run) -> float:
    """The model's flops in the window before the profiled part, over that
    time at the bf16 peak."""
    secs = run.untraced_seconds()
    steps = run.untraced()
    if not steps or secs <= 0:
        return None
    return 100.0 * sum(step_flops(run.config, s) for s in steps) / (
        secs * PEAK_FLOPS)


def idle_pct(run) -> float:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
