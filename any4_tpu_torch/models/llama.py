"""Functional Llama-family decoder in PyTorch (counterpart of
``any4_tpu/models/llama.py``).

Parameters are a nested dict: ``embed_tokens [vocab, d]``, ``norm [d]``,
``layers`` (a list of dicts of norms and linear weights) and, when the
embeddings are not tied, ``lm_head``. A linear weight is a dense ``[n, k]``
tensor or a :class:`~any4_tpu_torch.ops.linear.QuantizedTensor`; the
forward calls :func:`~any4_tpu_torch.ops.linear.linear` either way. A
layer may hold ``qkv_proj`` (and ``qkv_bias``) and ``gateup_proj`` in
place of q/k/v and gate/up (:mod:`.fuse`). ``embed_tokens`` may be
quantized: the lookup gathers and dequantizes rows
(:func:`~any4_tpu_torch.ops.linear.embed`), and a tied head runs the
quantized kernel on the same table.

Casts follow the JAX package: RMSNorm and RoPE tables in f32, attention
logits and softmax in f32 with the probabilities cast back to the model
dtype, SiLU in f32 then cast. The KV cache is a preallocated
``[b, max_len, n_kv, hd]`` tensor pair per layer that :func:`attention`
writes **in place** (the JAX package returns an updated copy from
``dynamic_update_slice``); the caches returned are the same tensors.

``capture`` (calibration and AWQ): the forwards of this module, of
:mod:`.mixtral` and of :mod:`.opt` record each linear's input under the
weight's dotted name (``layers.{i}.q_proj``, ...) at the JAX package's
sites, as per-channel ``(sum |x|, sum x, count)`` in f32 (:func:`_capture`);
a :class:`Capture` store made with ``raw=True`` also keeps the rows.

``tp_group`` (tensor parallelism, :mod:`any4_tpu_torch.parallel.tp`): the
forward runs on one rank's shards with the rank's head counts
(``tp.local_config``), and the partial outputs of the row-parallel
``o_proj`` and ``down_proj`` are summed over the group's ranks by
``torch.distributed.all_reduce`` (:func:`row_parallel`), where the JAX
package runs ``lax.psum`` over its mesh axis. The partials are summed in
float32 and the sum cast to the model's dtype once, as the unsharded
weight's output is rounded once; the JAX package sums bf16 partials.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops import linear as lin
from ..tracing import span


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    # --- Gemma-family options ---
    hidden_act: str = "silu"          # "silu" | "gelu_pytorch_tanh"
    rms_norm_offset: float = 0.0      # gemma: y = norm(x) * (offset + w)
    embed_scale: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    sliding_window: Optional[int] = None
    layer_types: Optional[Tuple[str, ...]] = None
    sandwich_norms: bool = False
    dtype: Any = torch.bfloat16

    def is_sliding(self, i: int) -> bool:
        """Does decoder layer ``i`` use sliding-window attention?"""
        if self.sliding_window is None:
            return False
        if self.layer_types is not None:
            return self.layer_types[i] == "sliding_attention"
        return i % 2 == 0  # gemma2 default: even layers are local

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def llama_3_2_1b(cls):
        return cls(vocab_size=128256, hidden_size=2048,
                   intermediate_size=8192, num_hidden_layers=16,
                   num_attention_heads=32, num_key_value_heads=8,
                   head_dim=64, rope_theta=500000.0,
                   max_position_embeddings=8192, tie_word_embeddings=True)

    @classmethod
    def llama_3_1_8b(cls):
        return cls(vocab_size=128256, hidden_size=4096,
                   intermediate_size=14336, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=8,
                   rope_theta=500000.0, max_position_embeddings=8192)

    @classmethod
    def tiny(cls, vocab=256, layers=2):
        """A tiny config for tests."""
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=layers, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=512)


def init_params(cfg: LlamaConfig, seed: int = 0,
                device="cuda") -> Dict:
    """Random-initialized parameters, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: linear weights
    ``N(0, 1/k)``, embeddings ``0.02 * N(0, 1)``, norms at their neutral
    value. (The numbers differ from the JAX package's ``jax.random``.)"""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size
    hd = cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    def dense(n_out, n_in):
        return (normal(n_out, n_in) * (1.0 / math.sqrt(n_in))).to(cfg.dtype)

    def norm_w():
        # gemma stores norm weights as (w - offset); neutral is 1.0
        return torch.full((d,), 1.0 - cfg.rms_norm_offset, dtype=cfg.dtype,
                          device=device)

    params: Dict[str, Any] = {
        "embed_tokens": normal(cfg.vocab_size, d).to(cfg.dtype) * 0.02,
        "layers": [],
        "norm": norm_w(),
    }
    for _ in range(cfg.num_hidden_layers):
        extra = ({"pre_feedforward_layernorm": norm_w(),
                  "post_feedforward_layernorm": norm_w()}
                 if cfg.sandwich_norms else {})
        params["layers"].append({
            **extra,
            "input_layernorm": norm_w(),
            "post_attention_layernorm": norm_w(),
            "q_proj": dense(nq * hd, d),
            "k_proj": dense(nkv * hd, d),
            "v_proj": dense(nkv * hd, d),
            "o_proj": dense(d, nq * hd),
            "gate_proj": dense(f, d),
            "up_proj": dense(f, d),
            "down_proj": dense(d, f),
        })
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(cfg.vocab_size, d)
    return params


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in f32; ``offset`` is gemma's ``(1 + w)`` convention."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * (offset + w.float())).to(dt)


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor):
    """cos/sin tables ``[..., head_dim/2]`` in f32 for given positions."""
    hd = cfg.head_dim_
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: ``[b, t, heads, hd]``; cos/sin: ``[b, t, hd/2]`` (half-split
    rotation)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def qkv(layer: Dict, cfg: LlamaConfig, x: torch.Tensor, **kw):
    """The q, k and v projections of ``x``, from ``qkv_proj`` (split as
    ``[nq * hd, nkv * hd, nkv * hd]``) when the layer has it."""
    if "qkv_proj" not in layer:
        return tuple(lin.linear(x, layer[f"{p}_proj"], layer.get(f"{p}_bias"),
                                **kw) for p in "qkv")
    hd = cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    out = lin.linear(x, layer["qkv_proj"], layer.get("qkv_bias"), **kw)
    return (out[..., :nq * hd], out[..., nq * hd:(nq + nkv) * hd],
            out[..., (nq + nkv) * hd:])


def tp_all_reduce(x: torch.Tensor, tp_group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``tp_group`` (partial outputs of
    a row-parallel layer), in place; ``x`` itself without a group."""
    if tp_group is not None:
        x = x.contiguous()
        dist.all_reduce(x, group=tp_group)
    return x


def row_parallel(x: torch.Tensor, w, bias=None, tp_group=None,
                 **kw) -> torch.Tensor:
    """``linear(x, w, bias)`` of a row-parallel projection. Under
    ``tp_group`` ``w`` and ``x`` are this rank's k slice: the product gives
    its partial sums in float32 (``out_dtype``), the ranks' partials are
    summed in float32, and the sum is cast to x's dtype once, as the
    unsharded weight's output is; rounding each partial first would round
    twice."""
    if tp_group is None:
        return lin.linear(x, w, bias, **kw)
    return tp_all_reduce(lin.linear(x, w, bias, out_dtype=torch.float32,
                                    **kw), tp_group).to(x.dtype)


def attention(layer: Dict, cfg: LlamaConfig, x: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]],
              cache_pos: Optional[int], mask: Optional[torch.Tensor],
              capture: Optional[dict] = None, prefix: str = "",
              tp_group=None, **kw):
    """GQA attention. Returns ``(out, kv_cache)``.

    ``kv_cache`` is ``(k_cache, v_cache)``, each ``[b, max_len, n_kv, hd]``,
    written in place at ``cache_pos`` (``None``: prefill writes ``[0, t)``).
    ``capture`` records the q/k/v input (under the three names, also when
    ``qkv_proj`` is fused) and o_proj's, prefixed by ``prefix``;
    ``tp_group`` sums o_proj's output over the group (:func:`row_parallel`).
    """
    b, t, _ = x.shape
    hd = cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if capture is not None:
        for nm in ("q_proj", "k_proj", "v_proj"):
            _capture(capture, f"{prefix}{nm}", x)
    q, k, v = qkv(layer, cfg, x, **kw)
    q = apply_rope(q.reshape(b, t, nq, hd), cos, sin)
    k = apply_rope(k.reshape(b, t, nkv, hd), cos, sin)
    v = v.reshape(b, t, nkv, hd)

    if kv_cache is not None:
        kc, vc = kv_cache
        p = 0 if cache_pos is None else int(cache_pos)
        with span("any4.kv.write"):
            kc[:, p:p + t] = k.to(kc.dtype)
            vc[:, p:p + t] = v.to(vc.dtype)
        k_all, v_all = kc, vc
    else:
        k_all, v_all = k, v

    with span("any4.attn.prefill"):
        rep = nq // nkv
        kx = torch.repeat_interleave(k_all, rep, dim=2)
        vx = torch.repeat_interleave(v_all, rep, dim=2)
        if cfg.query_pre_attn_scalar is not None:  # gemma2
            scale = cfg.query_pre_attn_scalar ** -0.5
        else:
            scale = 1.0 / math.sqrt(hd)
        logits = torch.einsum("bthd,bshd->bhts", q.float(),
                              kx.float()) * scale
        if cfg.attn_logit_softcapping is not None:  # gemma2, before the mask
            cap = cfg.attn_logit_softcapping
            logits = cap * torch.tanh(logits / cap)
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhts,bshd->bthd", probs, vx.to(x.dtype))
        out = out.reshape(b, t, nq * hd)
    if capture is not None:
        _capture(capture, f"{prefix}o_proj", out)
    out = row_parallel(out, layer["o_proj"], layer.get("o_bias"), tp_group,
                       **kw)
    return out, kv_cache


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return torch.nn.functional.silu(h)
    if act in ("gelu_pytorch_tanh", "gelu"):
        return torch.nn.functional.gelu(h, approximate="tanh")
    raise ValueError(f"unsupported hidden_act {act!r}")


def mlp(layer: Dict, x: torch.Tensor, act: str = "silu",
        capture: Optional[dict] = None, prefix: str = "", tp_group=None,
        **kw) -> torch.Tensor:
    if capture is not None:
        _capture(capture, f"{prefix}gate_proj", x)
        _capture(capture, f"{prefix}up_proj", x)
    if "gateup_proj" in layer:
        gu = lin.linear(x, layer["gateup_proj"], **kw)
        f = gu.shape[-1] // 2
        g, u = gu[..., :f], gu[..., f:]
    else:
        g = lin.linear(x, layer["gate_proj"], **kw)
        u = lin.linear(x, layer["up_proj"], **kw)
    h = _act(g.float(), act).to(x.dtype) * u
    if capture is not None:
        _capture(capture, f"{prefix}down_proj", h)
    return row_parallel(h, layer["down_proj"], None, tp_group, **kw)


def _sliding_mask(cfg, positions, s, mask):
    dist = positions[:, :, None] - torch.arange(s, device=positions.device)
    extra = torch.where(dist < cfg.sliding_window, 0.0, -1e9)[:, None]
    extra = extra.float()
    return extra if mask is None else mask + extra


def forward(params: Dict, cfg: LlamaConfig, input_ids: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            kv_caches: Optional[list] = None,
            cache_pos: Optional[int] = None,
            mask: Optional[torch.Tensor] = None,
            capture: Optional[dict] = None, tp_group=None, **kw):
    """Run the decoder. Returns ``(logits [b, t, vocab], kv_caches)``;
    ``kw`` goes to :func:`~any4_tpu_torch.ops.linear.linear`. ``capture``
    (a dict, or a :class:`Capture`) accumulates every linear's input
    statistics (:func:`_capture`); ``tp_group`` runs one rank's shards (the
    module docstring)."""
    b, t = input_ids.shape
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    cos, sin = rope_tables(cfg, positions)
    x = lin.embed(params["embed_tokens"], input_ids, cfg.dtype)
    if cfg.embed_scale is not None:  # gemma scales embeddings, in dtype
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)

    if mask is None and kv_caches is None and t > 1:
        mask = torch.where(torch.ones((t, t), dtype=torch.bool,
                                      device=dev).tril(),
                           0.0, -1e9)[None, None].float()
    sl_mask = None
    if cfg.sliding_window is not None:
        s = kv_caches[0][0].shape[1] if kv_caches is not None else t
        sl_mask = _sliding_mask(cfg, positions, s, mask)

    eps, off = cfg.rms_norm_eps, cfg.rms_norm_offset
    for i, layer in enumerate(params["layers"]):
        cap = dict(capture=capture, prefix=f"layers.{i}.", tp_group=tp_group)
        with span("any4.model.attn"):
            h = rms_norm(x, layer["input_layernorm"], eps, off)
            attn_out, _ = attention(
                layer, cfg, h, cos, sin,
                None if kv_caches is None else kv_caches[i],
                cache_pos, sl_mask if cfg.is_sliding(i) else mask, **cap,
                **kw)
            if cfg.sandwich_norms:  # gemma2: norm the attn output, then add
                attn_out = rms_norm(attn_out,
                                    layer["post_attention_layernorm"], eps,
                                    off)
            x = x + attn_out
        with span("any4.model.ffn"):
            if cfg.sandwich_norms:
                h = rms_norm(x, layer["pre_feedforward_layernorm"], eps, off)
                m = mlp(layer, h, act=cfg.hidden_act, **cap, **kw)
                x = x + rms_norm(m, layer["post_feedforward_layernorm"], eps,
                                 off)
            else:
                h = rms_norm(x, layer["post_attention_layernorm"], eps, off)
                x = x + mlp(layer, h, act=cfg.hidden_act, **cap, **kw)

    with span("any4.model.head"):
        x = rms_norm(x, params["norm"], eps, off)
        logits = head(params, x, **kw)
        if cfg.final_logit_softcapping is not None:  # gemma2
            cap = cfg.final_logit_softcapping
            logits = (cap * torch.tanh(logits.float() / cap)).to(
                logits.dtype)
    return logits, kv_caches


def head(params: Dict, x: torch.Tensor, **kw) -> torch.Tensor:
    """The LM head, in the JAX package's order: ``lm_head``, else a
    quantized tied ``embed_tokens`` through the quantized kernel, else the
    tied table as a plain matmul in x's dtype."""
    if "lm_head" in params:
        return lin.linear(x, params["lm_head"], **kw)
    emb = params["embed_tokens"]
    if isinstance(emb, lin.QuantizedTensor):
        return lin.linear(x, emb, **kw)
    return x @ emb.t().to(x.dtype)


class Capture(dict):
    """A ``capture`` store: ``{name: (sum |x|, sum x, count)}`` as a plain
    dict holds it and, made with ``raw=True``, ``rows[name]``: a list of
    each recorded input's rows ``[t, k]`` in f32, left on their device
    (AWQ searches on them)."""

    def __init__(self, raw: bool = False):
        super().__init__()
        self.rows = {} if raw else None


def _capture(store: dict, name: str, x: torch.Tensor):
    """Accumulate per-channel input statistics of the linear ``name`` into
    ``store``: ``(sum |x|, sum x, count)`` in f32 over every dimension but
    the last (the consumer picks absolute or signed means)."""
    xf = x.float()
    dims = tuple(range(x.ndim - 1))
    stats = (xf.abs().sum(dim=dims), xf.sum(dim=dims),
             math.prod(x.shape[:-1]))
    if name in store:
        store[name] = tuple(a + b for a, b in zip(store[name], stats))
    else:
        store[name] = stats
    rows = getattr(store, "rows", None)
    if rows is not None:
        rows.setdefault(name, []).append(xf.reshape(-1, x.shape[-1]))


def init_kv_caches(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                   device="cuda") -> list:
    dtype = dtype or cfg.dtype
    shape = (batch, max_len, cfg.num_key_value_heads, cfg.head_dim_)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_hidden_layers)]


def decode_mask(max_len: int, cache_pos, device="cuda") -> torch.Tensor:
    """Additive mask for single-token decode: attend to ``[0, cache_pos]``."""
    idx = torch.arange(max_len, device=device)
    return torch.where(idx <= cache_pos, 0.0, -1e9)[None, None, None, :]
