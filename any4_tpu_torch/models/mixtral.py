"""Functional Mixtral (sparse mixture of experts) decoder in PyTorch
(counterpart of ``any4_tpu/models/mixtral.py``).

Llama attention (:func:`.llama.attention`, which writes the KV caches in
place) and a top-k routed expert FFN. A layer holds ``router [E, d]`` and
its experts in one of three layouts: ``experts``, a list of dicts of
``w1`` (gate), ``w3`` (up) and ``w2`` (down); the same with ``w13`` (gate
and up fused by :func:`.fuse.fuse_projections`); or ``moe_w13 [E*2f, d]``
and ``moe_w2 [d, E*f]`` (:func:`.fuse.stack_experts`). Every expert weight
may be a :class:`~any4_tpu_torch.ops.linear.QuantizedTensor`; the router
stays dense, as ``quantize_model`` leaves it.

Routing follows the JAX package: the top k of the router logits in f32,
the lower index first among equal logits (a stable descending sort, as
``jax.lax.top_k`` orders ties), and a softmax over those k in f32.

Under tensor parallelism (``tp_group``) each expert's ``w1``/``w3`` are
column- and ``w2`` row-parallel on its FFN dim, the router is replicated
(so every rank routes alike and takes the same sparse branch), and one
all-reduce of the f32 combine sums the ranks' partials. Stacked experts
are refused there: ``moe_w13``/``moe_w2`` are split by no rule, so the
reduction would count every expert once a rank (the JAX package's
``tp.shard_params`` leaves them replicated and its ``moe_ffn`` still sums
them over the mesh axis).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..ops import linear as lin
from ..tracing import span
from . import llama


@dataclasses.dataclass(frozen=True)
class MixtralConfig(llama.LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2

    @classmethod
    def tiny(cls, vocab=256, layers=2):
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=96,
                   num_hidden_layers=layers, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=512,
                   num_local_experts=4, num_experts_per_tok=2)


def init_params(cfg: MixtralConfig, seed: int = 0, device="cuda") -> Dict:
    """Random-initialized parameters on ``device``: :func:`.llama.init_params`
    for the attention, norms and embeddings, then each layer's router and
    experts (``N(0, 1/k)``) from a second ``torch.Generator`` seeded with
    ``seed + 1``. (The numbers differ from the JAX package's
    ``jax.random``.)"""
    params = llama.init_params(cfg, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def dense(n_out, n_in):
        w = torch.randn((n_out, n_in), generator=gen, device=device,
                        dtype=torch.float32)
        return (w * (1.0 / n_in ** 0.5)).to(cfg.dtype)

    d, f = cfg.hidden_size, cfg.intermediate_size
    for layer in params["layers"]:
        for nm in ("gate_proj", "up_proj", "down_proj"):
            del layer[nm]
        layer["router"] = dense(cfg.num_local_experts, d)
        layer["experts"] = [{"w1": dense(f, d), "w3": dense(f, d),
                             "w2": dense(d, f)}
                            for _ in range(cfg.num_local_experts)]
    return params


def is_moe(layer: Dict) -> bool:
    """Does a decoder layer hold routed experts (any of the three
    layouts)?"""
    return "experts" in layer or "moe_w13" in layer


# Sparse dispatch pays only when most experts are expected unrouted: with
# T tokens and top-k routing over E experts, dispatch sparse only while
# T * k <= E / 2. The rule is the JAX package's, set by the cost of a TPU
# conditional; in the port it also decides when a layer reads its routed
# set to the host.
def _sparse_pays(tokens: int, top_k: int, n_experts: int) -> bool:
    return tokens * top_k <= max(n_experts // 2, 1)


def route(layer: Dict, cfg: MixtralConfig, x: torch.Tensor):
    """``(topi [b, t, k], gate [b, t, k])``: the experts of each token, the
    lower index first among equal router logits, and their softmax weights
    in f32."""
    logits = lin.linear(x, layer["router"]).float()          # [b, t, E]
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    return order.indices[..., :k], torch.softmax(order.values[..., :k],
                                                 dim=-1)


def moe_ffn(layer: Dict, cfg: MixtralConfig, x: torch.Tensor,
            dispatch: str = "auto", capture: Optional[dict] = None,
            prefix: str = "", tp_group=None, **kw) -> torch.Tensor:
    """Top-k routed expert FFN (HF semantics: softmax over the top-k router
    logits); ``kw`` goes to :func:`~any4_tpu_torch.ops.linear.linear`.

    ``dispatch`` (the per-expert layouts; stacked experts always run their
    two matmuls):

    - ``"dense"``: every expert runs on every token, and the outputs are
      combined by routing weight; the host never waits for the device.
    - ``"sparse"``: the layer reads its routed experts to the host (one read
      of the top-k indices) and skips the others. A routed expert runs the
      dense expression on every token, and a skipped one adds what dense
      adds for it (its output times a weight of 0), so both give the same
      bits.
    - ``"auto"``: sparse while :func:`_sparse_pays`.

    ``capture`` (per-expert layouts only, as in the JAX package) records
    the shared w1/w3 input as ``{prefix}moe`` and each expert's w2 input
    over every token as ``{prefix}experts.{e}.w2``, so it forces dense
    dispatch. ``tp_group``: the module docstring.
    """
    if "moe_w13" in layer and tp_group is not None \
            and dist.get_world_size(tp_group) > 1:
        raise ValueError(
            "stacked experts (moe_w13/moe_w2) cannot run tensor-parallel: "
            "they are not sharded, and the all-reduce would count every "
            "expert once a rank; use the per-expert layout")
    b, t, d = x.shape
    with span("any4.moe.route"):
        topi, gate = route(layer, cfg, x)
    E = cfg.num_local_experts

    with span("any4.moe.experts"):
        if "moe_w13" in layer:  # stacked experts (models/fuse.stack_experts)
            gu = lin.linear(x, layer["moe_w13"], **kw)        # [b, t, E*2f]
            f = gu.shape[-1] // (2 * E)
            gu = gu.reshape(b, t, E, 2, f).float()
            h = torch.nn.functional.silu(gu[..., 0, :]).to(x.dtype) * \
                gu[..., 1, :].to(x.dtype)                      # [b, t, E, f]
            # the routing weight of each expert folds into w2's input segments
            wts = (torch.nn.functional.one_hot(topi, E).float()
                   * gate[..., None]).sum(dim=-2)              # [b, t, E]
            hw = (h.float() * wts[..., None]).to(x.dtype)
            y = lin.linear(hw.reshape(b, t, E * f), layer["moe_w2"], **kw)
            return y.to(x.dtype)

        if dispatch == "auto":
            dispatch = ("sparse" if _sparse_pays(
                b * t, cfg.num_experts_per_tok, E) else "dense")
        if capture is not None:
            llama._capture(capture, f"{prefix}moe", x)
            dispatch = "dense"
        routed = (set(topi.unique().tolist()) if dispatch == "sparse"
                  else range(E))

        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for e, expert in enumerate(layer["experts"]):
            if e not in routed:
                continue
            if "w13" in expert:   # fused gate/up (models/fuse.py)
                gu = lin.linear(x, expert["w13"], **kw)
                f2 = gu.shape[-1] // 2
                g, u = gu[..., :f2], gu[..., f2:]
            else:
                g = lin.linear(x, expert["w1"], **kw)
                u = lin.linear(x, expert["w3"], **kw)
            h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
            if capture is not None:
                llama._capture(capture, f"{prefix}experts.{e}.w2", h)
            ye = lin.linear(h, expert["w2"], **kw).float()
            weight = torch.where(topi == e, gate, 0.0).sum(dim=-1)   # [b, t]
            out = out + ye * weight[..., None]
        return llama.tp_all_reduce(out, tp_group).to(x.dtype)


def forward(params: Dict, cfg: MixtralConfig, input_ids: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            kv_caches: Optional[list] = None,
            cache_pos: Optional[int] = None,
            mask: Optional[torch.Tensor] = None,
            capture: Optional[dict] = None, tp_group=None, **kw):
    """Run the decoder. Returns ``(logits [b, t, vocab], kv_caches)``; the
    caches are written in place. ``kw`` goes to
    :func:`~any4_tpu_torch.ops.linear.linear`; ``capture`` and
    ``tp_group`` as in :func:`.llama.forward` and :func:`moe_ffn`."""
    b, t = input_ids.shape
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    cos, sin = llama.rope_tables(cfg, positions)
    x = lin.embed(params["embed_tokens"], input_ids, cfg.dtype)

    if mask is None and kv_caches is None and t > 1:
        mask = torch.where(torch.ones((t, t), dtype=torch.bool,
                                      device=dev).tril(),
                           0.0, -1e9)[None, None].float()

    eps = cfg.rms_norm_eps
    for i, layer in enumerate(params["layers"]):
        cap = dict(capture=capture, prefix=f"layers.{i}.", tp_group=tp_group)
        with span("any4.model.attn"):
            h = llama.rms_norm(x, layer["input_layernorm"], eps)
            attn_out, _ = llama.attention(
                layer, cfg, h, cos, sin,
                None if kv_caches is None else kv_caches[i], cache_pos, mask,
                **cap, **kw)
            x = x + attn_out
        with span("any4.model.ffn"):
            h = llama.rms_norm(x, layer["post_attention_layernorm"], eps)
            x = x + moe_ffn(layer, cfg, h, **cap, **kw)

    with span("any4.model.head"):
        x = llama.rms_norm(x, params["norm"], eps)
        return llama.head(params, x, **kw), kv_caches
