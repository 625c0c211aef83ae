"""The plain reference: a Llama, Mistral or Mixtral decoder in float32
PyTorch, with TF32 off, from the drawn fields of :mod:`portbench.inputs`
(it dequantizes them itself, by the format's ``formats/<format>.py``).

It follows the published architecture: RMSNorm, RoPE (half-split, base
``rope_theta``), grouped-query causal attention with a softmax in f32,
SwiGLU MLP, or a router whose top ``num_experts_per_tok`` logits (the lower
index first among equal ones) are softmaxed and weight their experts'
SwiGLU outputs; final RMSNorm and the head. No KV cache, no kernels, no
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

from portbench import inputs

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    """The reference of one configuration file's model with ``seed``'s
    weights, on ``device``."""

    def __init__(self, config: dict, seed: int, device, act: Optional[str]
                 = None):
        if act not in (None, "fp8"):
            raise ValueError(f"act must be None or 'fp8', got {act!r}")
        no_tf32()
        self.config, self.seed, self.device, self.act = (config, seed,
                                                         device, act)
        hf = inputs.hf
        self.d = hf(config, "hidden_size")
        self.hd = inputs.head_dim(config)
        self.nq = hf(config, "num_attention_heads")
        self.nkv = hf(config, "num_key_value_heads", self.nq)
        self.eps = hf(config, "rms_norm_eps")
        self.theta = hf(config, "rope_theta")
        self.layers = hf(config, "num_hidden_layers")
        self.experts = hf(config, "num_local_experts")
        self.top_k = hf(config, "num_experts_per_tok")
        if hf(config, "hidden_act", "silu") != "silu":
            raise ValueError("the reference runs SiLU MLPs only")
        if hf(config, "sliding_window") is not None:
            raise ValueError("the reference runs full attention only")

    def _s(self, x):
        """``x`` as the port stores it in bf16: rounded to fp8 under the
        control, untouched otherwise."""
        return _fp8(x) if self.act == "fp8" else x

    def _lin(self, x, w):
        return self._s(x @ w.t())

    def _norm(self, x):
        # the drawn norm weights are all 1
        return self._s(x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                                       + self.eps))

    def _rope(self, x, pos):
        """``x [t, heads, hd]`` rotated at positions ``pos [t]``."""
        half = self.hd // 2
        inv = self.theta ** (-torch.arange(0, self.hd, 2, device=x.device,
                                           dtype=torch.float64) / self.hd)
        ang = pos.double()[:, None] * inv[None, :]
        c, s = ang.cos().float()[:, None], ang.sin().float()[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def _attention(self, h, w):
        t = h.shape[0]
        pos = torch.arange(t, device=h.device)
        q = self._s(self._rope(
            self._lin(h, w["q_proj"]).view(t, self.nq, self.hd), pos))
        k = self._s(self._rope(
            self._lin(h, w["k_proj"]).view(t, self.nkv, self.hd), pos))
        v = self._lin(h, w["v_proj"]).view(t, self.nkv, self.hd)
        rep = self.nq // self.nkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        logits = torch.einsum("thd,shd->hts", q, k) / math.sqrt(self.hd)
        causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
        logits = logits.masked_fill(~causal, float("-inf"))
        probs = self._s(torch.softmax(logits, -1))
        out = self._s(torch.einsum("hts,shd->thd", probs, v))
        return self._lin(out.reshape(t, self.nq * self.hd), w["o_proj"])

    def _swiglu(self, h, w1, w3, w2):
        act = self._s(torch.nn.functional.silu(self._lin(h, w1)))
        return self._lin(self._s(act * self._lin(h, w3)), w2)

    def _moe(self, h, w, router):
        logits = h @ router.t()
        order = torch.sort(logits, dim=-1, descending=True, stable=True)
        # how far each position's last chosen expert lies above the first
        # one left out (none is left out when every expert is chosen)
        self.margin = (order.values[:, self.top_k - 1]
                       - order.values[:, self.top_k]
                       if self.top_k < self.experts
                       else torch.full_like(logits[:, 0], math.inf))
        top = order.indices[:, :self.top_k]
        gate = torch.softmax(order.values[:, :self.top_k], dim=-1)
        out = torch.zeros_like(h)
        for e in range(self.experts):
            rows, slot = (top == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            y = self._swiglu(h[rows], w[f"experts.{e}.w1"],
                             w[f"experts.{e}.w3"], w[f"experts.{e}.w2"])
            out.index_add_(0, rows, y * gate[rows, slot][:, None])
        return self._s(out)

    def hidden(self, seqs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The final normed hidden states ``[t, d]`` f32 of each id sequence
        (positions from 0). For a routed model, ``min_margin[i] [t]`` is
        then each position's smallest router margin over the layers."""
        dense = inputs.draw_dense(self.config, self.seed, self.device)
        emb = dense["embed_tokens"]
        xs = [self._s(emb[s.to(self.device).long()].float()) for s in seqs]
        del dense, emb
        self.min_margin = [torch.full((x.shape[0],), math.inf,
                                      device=x.device) for x in xs]
        for li in range(self.layers):
            fields, router = inputs.draw_layer(self.config, self.seed, li,
                                               self.device)
            w = {n: inputs.dequantize(self.config, f)
                 for n, f in fields.items()}
            del fields
            r = None if router is None else router.float()
            for i, x in enumerate(xs):
                x = self._s(x + self._attention(self._norm(x), w))
                h = self._norm(x)
                if r is not None:
                    x = x + self._moe(h, w, r)
                    self.min_margin[i] = torch.minimum(self.min_margin[i],
                                                       self.margin)
                else:
                    x = x + self._swiglu(h, w["gate_proj"], w["up_proj"],
                                         w["down_proj"])
                xs[i] = self._s(x)
            del w
        return [self._norm(x) for x in xs]

    def logits(self, h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """Logits of final hidden states ``h`` under ``head``."""
        return self._s(h @ head.t())

    def head(self) -> torch.Tensor:
        """The head ``[vocab, d]`` in f32 (the embedding when tied)."""
        dense = inputs.draw_dense(self.config, self.seed, self.device)
        return dense.get("lm_head", dense["embed_tokens"]).float()
