"""The plain reference: a decoder in float32 PyTorch, with TF32 off, from
the drawn fields of :mod:`portbench.inputs` (it dequantizes them itself,
by the format's ``formats/<format>.py``).

It follows the published architecture, whose layer is
``archs/<model_type>.py``'s ``layer``: the embedding, each decoder layer
in turn, the final RMSNorm and the head. No KV cache, no kernels, no
batching: each sequence runs whole, layer by layer, and each layer's
weights are drawn and dequantized once for all sequences, so that one
layer's float32 weights are held at a time.

``act="fp8"`` is the control, the reference computed in the step below
the configuration's bf16: every tensor that the port holds in bf16
(embeddings, norm outputs, q, k and v as cached, attention probabilities
and outputs, every linear's output, the residual stream, the MLP's
products, the logits) is rounded to float8 e4m3 with a scale per row
(``amax / 448``).

It imports nothing of the port.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from portbench import archs, inputs

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    """The reference of one configuration file's model with ``seed``'s
    weights, on ``device``. The architecture's layers call :meth:`s`,
    :meth:`lin` and :meth:`norm`."""

    def __init__(self, config: dict, seed: int, device, act: Optional[str]
                 = None):
        if act not in (None, "fp8"):
            raise ValueError(f"act must be None or 'fp8', got {act!r}")
        no_tf32()
        self.config, self.seed, self.device, self.act = (config, seed,
                                                         device, act)
        self.arch = archs.of(config)
        self.arch.check(config)
        self.eps = inputs.hf(config, "rms_norm_eps")
        self.layers = inputs.hf(config, "num_hidden_layers")
        self.min_margin = None

    def s(self, x):
        """``x`` as the port stores it in bf16: rounded to fp8 under the
        control, untouched otherwise."""
        return _fp8(x) if self.act == "fp8" else x

    def lin(self, x, w):
        return self.s(x @ w.t())

    def norm(self, x):
        # the drawn norm weights are all 1
        return self.s(x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                                      + self.eps))

    def hidden(self, seqs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The final normed hidden states ``[t, d]`` f32 of each id sequence
        (positions from 0). ``min_margin[i] [t]`` is then each position's
        smallest router margin over the layers that route (inf where every
        expert is chosen), or ``min_margin`` None when no layer routes."""
        dense = inputs.draw_dense(self.config, self.seed, self.device)
        emb = dense["embed_tokens"]
        xs = [self.s(emb[s.to(self.device).long()].float()) for s in seqs]
        del dense, emb
        margins = [None] * len(xs)
        for li in range(self.layers):
            fields, leaves = inputs.draw_layer(self.config, self.seed, li,
                                               self.device)
            w = {n: inputs.dequantize(self.config, f)
                 for n, f in fields.items()}
            w.update((n, t.float()) for n, t in leaves.items())
            del fields, leaves
            for i, x in enumerate(xs):
                xs[i], m = self.arch.layer(self, x, w, li)
                if m is not None:
                    margins[i] = m if margins[i] is None else torch.minimum(
                        margins[i], m)
            del w
        self.min_margin = margins if margins and margins[0] is not None \
            else None
        return [self.norm(x) for x in xs]

    def logits(self, h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """Logits of final hidden states ``h`` under ``head``."""
        return self.s(h @ head.t())

    def head(self) -> torch.Tensor:
        """The head ``[vocab, d]`` in f32 (the embedding when tied)."""
        dense = inputs.draw_dense(self.config, self.seed, self.device)
        return dense.get("lm_head", dense["embed_tokens"]).float()
