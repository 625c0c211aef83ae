"""The inputs of a run, made from ``--seed``: the quantized weights' fields
and the traffic. Both sides get the same: the program builds its packed
weights from these fields, and the reference dequantizes them itself.

Plain PyTorch and NumPy; nothing of the port.

The quantized linears' fields are drawn by the configuration's format
(``formats/<format>.py``), not learned. Routers, norms, the embedding and
the head are dense, as ``quantize_model`` leaves them: norms 1, embedding
``0.02 N(0, 1)``, head ``N(0, 1/d)``, in bf16. Each layer's fields come
from a generator of their own on the device, so that the reference can
draw one layer again after the program is gone. Which linears and dense
leaves a layer has, and how they are drawn, is its architecture's
(``archs/<model_type>.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import archs


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for the part ``tags`` of a run with ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def hf(config: dict, key: str, default=None):
    """A published key of the configuration file (its ``config.json``
    keys sit at the top level, beside the benchmark's own)."""
    v = config.get(key)
    return default if v is None else v


def layer_linears(config: dict, layer: int) -> List[Tuple[str, int, int]]:
    """``(name, n, k)`` of layer ``layer``'s quantized linears, in the
    order they are drawn, by the configuration's architecture."""
    return archs.of(config).linears(config, layer)


def quant_format(config: dict):
    """The module of the configuration's quantization format."""
    from . import formats
    return formats.load(config["quantization"]["format"])


def draw_layer(config: dict, seed: int, layer: int, device):
    """Layer ``layer``'s quantized linears' fields (by name, in the
    format's own type) and its dense bf16 leaves (by name: a router), both
    from the layer's own generator, the linears first."""
    g = config["quantization"]["group_size"]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 1, layer))
    out = quant_format(config).draw(gen, layer_linears(config, layer), g,
                                    device)
    return out, archs.of(config).draw_dense(config, layer, gen, device)


def draw_dense(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The dense bf16 leaves outside the layers: ``embed_tokens``,
    ``lm_head`` (an untied head), one call each."""
    d, v = hf(config, "hidden_size"), hf(config, "vocab_size")
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 2))
    out = {"embed_tokens": (torch.randn((v, d), generator=gen, device=device)
                            * 0.02).to(torch.bfloat16)}
    if not hf(config, "tie_word_embeddings", False):
        out["lm_head"] = (torch.randn((v, d), generator=gen, device=device)
                          / math.sqrt(d)).to(torch.bfloat16)
    return out


def dequantize(config: dict, f) -> torch.Tensor:
    """One linear's drawn fields dequantized in f32, ``[n, k]``, by the
    configuration's format."""
    return quant_format(config).dequantize(
        f, config["quantization"]["group_size"])


# ------------------------------------------------------------------ traffic
def lengths(spec: dict, count: int) -> np.ndarray:
    """``count`` lengths at the stratified quantiles of ``spec``'s
    distribution (``loguniform`` over ``[lo, hi]``, or ``fixed``), so that
    every seed gets the same set of lengths."""
    u = (np.arange(count) + 0.5) / count
    if spec["dist"] == "fixed":
        return np.full(count, int(spec["value"]))
    if spec["dist"] != "loguniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lo, hi = math.log(spec["lo"]), math.log(spec["hi"])
    return np.rint(np.exp(lo + u * (hi - lo))).astype(np.int64)


@dataclass
class ServeRequest:
    prompt: np.ndarray        # int32 ids
    max_new_tokens: int


def client_requests(traffic: dict, vocab: int, seed: int
                    ) -> List[List[ServeRequest]]:
    """Each closed-loop client's requests, in the order it sends them.

    The traffic's ``pool`` holds requests whose prompt and output lengths
    are the stratified quantiles of their distributions, paired in one
    fixed order, and dealt in turn to the ``clients``; a client sends its
    share again and again, ``queue / clients`` requests in all. So every
    seed serves the same sizes at the same times: the seed deals the
    shares to other clients and draws the ids (uniform over the
    vocabulary). A client's first request is in flight when the window
    opens and asks for a residual ``ceil(u L)`` of its output length
    ``L``, ``u`` at stratified points paired with the clients in a fixed
    order."""
    fixed = np.random.default_rng(0)
    pool, n = traffic["pool"], traffic["clients"]
    plens = lengths(traffic["prompt_len"], pool)[fixed.permutation(pool)]
    olens = lengths(traffic["output_len"], pool)
    shares = [list(zip(plens[c::n], olens[c::n])) for c in range(n)]
    u = (fixed.permutation(n) + 0.5) / n
    rng = np.random.default_rng(subseed(seed, 3))
    per = max(1, traffic["queue"] // n)
    out = []
    for c in rng.permutation(n):
        share = shares[c]
        reqs = []
        for i in range(per):
            p, o = share[i % len(share)]
            ids = rng.integers(0, vocab, size=int(p), dtype=np.int64)
            if i == 0:
                o = max(1, math.ceil(u[c] * o))
            reqs.append(ServeRequest(ids.astype(np.int32), int(o)))
        out.append(reqs)
    return out


def open_arrivals(traffic: dict, vocab: int, seed: int
                  ) -> List[Tuple[float, ServeRequest]]:
    """An open loop's ``queue`` requests with their offsets in seconds from
    the window's opening, in order: groups of ``arrivals["group"]`` (1 by
    default) at a mean of ``arrivals["rate"]`` requests a second. The gaps
    between groups are the stratified quantiles of the exponential
    distribution, and the sizes those of the traffic's lengths (a
    ``pool``, paired in one fixed order), so every seed has the same gaps
    and sizes; the seed puts both in its own order and draws the ids."""
    a = traffic["arrivals"]
    n, group = traffic["queue"], int(a.get("group", 1))
    groups = -(-n // group)
    u = (np.arange(groups) + 0.5) / groups
    gaps = -np.log1p(-u) * group / float(a["rate"])
    fixed = np.random.default_rng(0)
    pool = traffic["pool"]
    plens = lengths(traffic["prompt_len"], pool)[fixed.permutation(pool)]
    olens = lengths(traffic["output_len"], pool)
    rng = np.random.default_rng(subseed(seed, 7))
    at = np.cumsum(rng.permutation(gaps))
    order = np.concatenate([rng.permutation(pool)
                            for _ in range(-(-n // pool))])[:n]
    out = []
    for i, j in enumerate(order):
        ids = rng.integers(0, vocab, size=int(plens[j]), dtype=np.int64)
        out.append((float(at[i // group]),
                    ServeRequest(ids.astype(np.int32), int(olens[j]))))
    return out


def synthetic_stream(vocab: int, n_tokens: int, seed: int) -> np.ndarray:
    """A Zipf-like token stream with local repeats (each token repeats the
    one before it with probability 0.1): the same distribution as
    ``any4_tpu_torch.evals.datasets.synthetic_tokens``, vectorized and
    drawn from a 64-bit seed."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
    ids = rng.choice(vocab, size=n_tokens, p=p / p.sum())
    rep = rng.random(n_tokens) < 0.1
    rep[0] = False
    src = np.maximum.accumulate(np.where(rep, 0, np.arange(n_tokens)))
    return ids[src].astype(np.int32)


def score_windows(traffic: dict, vocab: int, seed: int,
                  count: int) -> List[np.ndarray]:
    """The first ``count`` windows of ``seqlen`` tokens: a pool of
    ``pool`` windows cut from one synthetic stream of the seed, passed
    through again and again, each pass in another order."""
    rng = np.random.default_rng(subseed(seed, 4))
    L, pool = traffic["seqlen"], traffic["pool"]
    stream = synthetic_stream(vocab, L * pool, subseed(seed, 5))
    wins = stream.reshape(pool, L)
    out: List[np.ndarray] = []
    while len(out) < count:
        out += [wins[i] for i in rng.permutation(pool)]
    return out[:count]
