"""Continuous-batching inference engine over the paged KV cache (counterpart
of ``any4_tpu/serving/engine.py``).

A host-side scheduler (admit / step / retire) around a single-sequence
prefill that writes a prompt's KV into the pool and a batched decode step
over all slots. Prompts are padded to power-of-two buckets and the page
table is cut to a power-of-two bucket of pages, as in the JAX package, so
both packages do the same work and give the same tokens.

The KV pools, the page table and the per-slot token and length state live
on the engine's device, and the pools are written in place. A burst of
decode steps is a Python loop in which each step takes its argmax on the
device and feeds the next, so the host waits for the device only when it
reads a burst's tokens (:meth:`Engine._absorb_burst`); that is what the JAX
package's ``scan`` with a device-resident carry buys. ``run(pipeline=True)``
dispatches the next burst before reading the last one.

The decode step uses fused projections (``qkv_proj``/``gateup_proj``,
:mod:`..models.fuse`) and a quantized ``embed_tokens`` (its rows gathered
and dequantized, and as a tied head through the quantized kernel) as
``llama.forward`` does.

A tree of MoE layers (:mod:`..models.mixtral`: per-expert, ``w13``-fused
or stacked experts) prefills through ``mixtral.forward``, and the decode
step routes its FFN to ``mixtral.moe_ffn(dispatch="dense")``: every expert
runs on every slot, so a burst never waits for the host to read the routed
set. Sparse and dense dispatch give the same bits, so the tokens are those
of the JAX engine's ``auto`` dispatch.

Not ported: tensor parallelism (``mesh``/``param_spec``), which raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models import llama, mixtral
from ..models.generate import _check_device, _model_forward
from ..ops import linear as lin
from . import kv_cache as kvc


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [t] int32
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    out_tokens: list = field(default_factory=list)
    done: bool = False


def _ffn(layer, cfg, h):
    """One decode-step layer's dense MLP, or its routed MoE FFN with dense
    dispatch (see the module docstring)."""
    if mixtral.is_moe(layer):
        return mixtral.moe_ffn(layer, cfg, h, dispatch="dense")
    return llama.mlp(layer, h, act=cfg.hidden_act)


def _prefill_impl(params, cfg, prompt, true_len, k_pages, v_pages,
                  table_row, page_size, kv_layout="paged"):
    """Run one bucket-padded prompt ``[1, L]`` and write its first
    ``true_len`` positions of KV into the pools, in place. Returns the last
    real position's logits ``[vocab]``."""
    dev = prompt.device
    L = prompt.shape[1]
    pos = torch.arange(L, device=dev)
    mask = torch.where((pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                         < true_len),
                       0.0, -1e9)[None, None].float()
    # temporary dense cache for the prefill, then scatter into pages
    caches = llama.init_kv_caches(cfg, 1, L, device=dev)
    logits, caches = _model_forward(params)(
        params, cfg, prompt, positions=pos[None, :], kv_caches=caches,
        cache_pos=None, mask=mask)
    page_ids = table_row[pos // page_size]
    offsets = pos % page_size
    if kv_layout != "contig":
        # padded positions write to page 0, the reserved scratch sink. The
        # contiguous layout has no sink (page 0 belongs to slot 0): padded
        # positions write into the slot's own region, beyond true_len,
        # where seq_len masks them until decode overwrites them.
        real = pos < true_len
        page_ids = torch.where(real, page_ids, 0)
        offsets = torch.where(real, offsets, 0)
    for li in range(cfg.num_hidden_layers):
        kc, vc = caches[li]
        kvc.write_tokens(k_pages[li], kc, page_ids[None], offsets[None])
        kvc.write_tokens(v_pages[li], vc, page_ids[None], offsets[None])
    return logits[0, true_len - 1]


def _decode_impl(params, cfg, tokens, seq_lens, tables, k_pages, v_pages,
                 page_size, kv_layout="paged"):
    """One decode step for all slots; writes each slot's new K/V into the
    pools in place.

    tokens: ``[b]`` int32 current token per slot; seq_lens: ``[b]`` int32,
    the new token's position; tables: ``[b, pps]`` int32. Returns logits
    ``[b, vocab]``.
    """
    b = tokens.shape[0]
    cos, sin = llama.rope_tables(cfg, seq_lens[:, None])
    x = lin.embed(params["embed_tokens"], tokens[:, None], cfg.dtype)
    if cfg.embed_scale is not None:  # gemma scales embeddings, in dtype
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)

    # per-slot write target for the new token. The page index is CLAMPED to
    # the bucketed table width: an inactive slot can carry a stale seq_len
    # past the bucket, and its write would otherwise land on an arbitrary
    # page (in the contiguous layout: live data of another slot).
    pidx = torch.clamp(seq_lens // page_size, max=tables.shape[1] - 1)
    page_ids = tables.gather(1, pidx[:, None].long())           # [b, 1]
    offsets = (seq_lens % page_size)[:, None]

    hd = cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    eps, off = cfg.rms_norm_eps, cfg.rms_norm_offset
    # gemma2 attention options, which the attention routes to its dense path
    attn_scale = (cfg.query_pre_attn_scalar ** -0.5
                  if cfg.query_pre_attn_scalar is not None else None)
    softcap = cfg.attn_logit_softcapping
    attn = (kvc.contig_attention if kv_layout == "contig"
            else kvc.paged_attention)
    for li, layer in enumerate(params["layers"]):
        h = llama.rms_norm(x, layer["input_layernorm"], eps, off)
        q, k, v = llama.qkv(layer, cfg, h)
        q = llama.apply_rope(q.reshape(b, 1, nq, hd), cos, sin)
        k = llama.apply_rope(k.reshape(b, 1, nkv, hd), cos, sin)
        v = v.reshape(b, 1, nkv, hd)
        kvc.write_tokens(k_pages[li], k, page_ids, offsets)
        kvc.write_tokens(v_pages[li], v, page_ids, offsets)
        # the new token was just written at position seq_len, so the
        # visible length is seq_len + 1
        out = attn(q[:, 0], k_pages[li], v_pages[li], seq_lens + 1, tables,
                   scale=attn_scale, softcap=softcap,
                   window=(cfg.sliding_window if cfg.is_sliding(li)
                           else None))
        out = lin.linear(out.to(x.dtype).reshape(b, 1, nq * hd),
                         layer["o_proj"], layer.get("o_bias"))
        if cfg.sandwich_norms:  # gemma2: norm attn/ffn outputs, then add
            out = llama.rms_norm(out, layer["post_attention_layernorm"],
                                 eps, off)
            x = x + out
            h = llama.rms_norm(x, layer["pre_feedforward_layernorm"],
                               eps, off)
            m = _ffn(layer, cfg, h)
            x = x + llama.rms_norm(m, layer["post_feedforward_layernorm"],
                                   eps, off)
        else:
            x = x + out
            h = llama.rms_norm(x, layer["post_attention_layernorm"], eps,
                               off)
            x = x + _ffn(layer, cfg, h)

    logits = llama.head(params, llama.rms_norm(x, params["norm"], eps, off))
    if cfg.final_logit_softcapping is not None:  # gemma2
        cap = cfg.final_logit_softcapping
        logits = (cap * torch.tanh(logits.float() / cap)).to(logits.dtype)
    return logits[:, -1, :]


def _decode_burst_impl(params, cfg, tokens, seq_lens, tables, k_pages,
                       v_pages, page_size, n_steps, kv_layout="paged"):
    """``n_steps`` greedy decode steps for all slots, each feeding its
    on-device argmax to the next; page tables are fixed for the burst (the
    scheduler reserves ``n_steps`` positions per slot). Returns
    ``(tokens [b, n_steps], last [b], lens [b])`` on the device: the final
    (token, seq_len) carry lets the next burst start without an upload."""
    out = []
    for _ in range(n_steps):
        logits = _decode_impl(params, cfg, tokens, seq_lens, tables,
                              k_pages, v_pages, page_size,
                              kv_layout=kv_layout)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        seq_lens = seq_lens + 1
        out.append(tokens)
    return torch.stack(out, dim=1), tokens, seq_lens


class Engine:
    """Continuous-batching engine: admit requests into slots, run batched
    decode, retire finished sequences and recycle their pages."""

    MIN_PREFILL_BUCKET = 16

    def __init__(self, params, cfg, max_slots: int = 8,
                 max_ctx: int = 512, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 sample_fn: Optional[Callable] = None,
                 kv_quantize: bool = False,
                 kv_layout: str = "paged",
                 mesh=None, param_spec=None, device="cuda"):
        """``kv_layout``: "contig" gives every slot a fixed contiguous region
        of the KV pool (attention without a page table); "paged" keeps the
        free-list allocator and page-table attention. The pools and the
        decode state live on ``device``, where ``params`` must already
        be."""
        if kv_layout not in ("contig", "paged"):
            raise ValueError(f"kv_layout must be 'contig' or 'paged', got "
                             f"{kv_layout!r}")
        if mesh is not None or param_spec is not None:
            raise NotImplementedError(
                "the tensor-parallel engine is not ported yet (ROADMAP queue "
                "1, item 12)")
        self.device = _check_device(params, device)
        self.params = params
        self.cfg = cfg
        self.page_size = page_size
        self.kv_layout = kv_layout
        if kv_layout == "contig":
            # slot regions are whole blocks of the JAX package's contiguous
            # kernel, so both packages size the pool alike
            blk = max(kvc.CONTIG_BLOCK_TOKENS, page_size)
            max_ctx = -(-max_ctx // blk) * blk
        self.pps = -(-max_ctx // page_size)
        self.max_ctx = self.pps * page_size
        self.max_slots = max_slots
        num_pages = num_pages or (max_slots * self.pps +
                                  (0 if kv_layout == "contig" else 1))
        self.cache = kvc.PagedKVCache.create(cfg, num_pages, page_size,
                                             quantize=kv_quantize,
                                             device=self.device)
        self.alloc = kvc.PageAllocator(num_pages, max_slots, self.pps,
                                       contiguous=kv_layout == "contig")
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.tokens = np.zeros(max_slots, np.int32)
        self.seq_lens = np.zeros(max_slots, np.int32)
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self._uid = 0
        self._greedy = sample_fn is None
        self.sample_fn = sample_fn or (lambda lg: torch.argmax(lg, dim=-1))
        # device-resident decode state: a burst returns its final (token,
        # seq_len) carry, so steady-state decode (no admissions or
        # retirements between bursts) chains bursts with no upload; the host
        # mirrors (self.tokens/self.seq_lens) stay the bookkeeping truth and
        # re-seed the device only when dirty
        self._d_tokens = None
        self._d_seq_lens = None
        self._host_dirty = True
        self._tbl_cache = (None, None, None)   # (bucket, version, tensor)
        self.decode_steps = 0                  # batched steps dispatched

    def _upload(self, a) -> torch.Tensor:
        """A host array as a tensor on the engine's device. The copy
        ``np.array`` makes keeps later host updates out of it, and a CUDA
        upload goes through pinned memory without waiting for queued
        work."""
        t = torch.from_numpy(np.array(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ----------------------------------------------------------- requests
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None) -> int:
        self._uid += 1
        self.pending.append(Request(self._uid, np.asarray(prompt, np.int32),
                                    max_new_tokens, eos_token_id))
        return self._uid

    def _bucket(self, n: int) -> int:
        L = self.MIN_PREFILL_BUCKET
        while L < n:
            L *= 2
        return min(L, self.max_ctx)

    def _ctx_table(self, extra: int) -> torch.Tensor:
        """Page table cut to a power-of-two page bucket covering every
        active slot's length + ``extra`` new positions; the device copy is
        reused while the bucket and the allocator's version hold."""
        need = 1
        for i, r in enumerate(self.slots):
            if r is not None:
                need = max(need, int(self.seq_lens[i]) + extra)
        pages = -(-need // self.page_size)
        bucket = 1
        while bucket < pages:
            bucket *= 2
        bucket = min(bucket, self.pps)
        cb, cv, arr = self._tbl_cache
        if cb == bucket and cv == self.alloc.version:
            return arr                      # device copy still valid
        arr = self._upload(self.alloc.table[:, :bucket])
        self._tbl_cache = (bucket, self.alloc.version, arr)
        return arr

    def _admit(self):
        newly = []
        for i in range(self.max_slots):
            if self.slots[i] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            if len(req.prompt) >= self.max_ctx:
                # keep the most recent context (positions restart at 0 for
                # the truncated prompt); without this an oversized prompt
                # can never be admitted and blocks the queue head forever
                req.prompt = req.prompt[-(self.max_ctx - 1):]
            t = len(req.prompt)
            if not self.alloc.ensure(i, t + 1, self.page_size):
                self.pending.insert(0, req)
                break
            L = self._bucket(t)
            padded = np.zeros(L, np.int32)
            padded[:t] = req.prompt
            last_logits = _prefill_impl(
                self.params, self.cfg, self._upload(padded[None]),
                min(t, L), self.cache.k_pages, self.cache.v_pages,
                self._upload(self.alloc.table[i]), self.page_size,
                kv_layout=self.kv_layout)
            newly.append((i, req, self.sample_fn(last_logits[None])))
            self.slots[i] = req
            self.seq_lens[i] = t
        if newly:
            # one host read for the whole admission wave
            vals = torch.cat([torch.as_tensor(tok, device=self.device)
                              .reshape(-1) for _, _, tok in newly]).cpu()
            for (i, req, _), v in zip(newly, vals.tolist()):
                req.out_tokens.append(int(v))
                self.tokens[i] = int(v)
            self._host_dirty = True   # device token/len state is stale

    def _retire(self, i: int):
        req = self.slots[i]
        req.done = True
        self.finished.append(req)
        self.slots[i] = None
        self.alloc.release(i)
        # reset the slot's decode state: a stale seq_len past the context
        # bucket makes the (masked, ignored) inactive-slot decode write out
        # of table bounds (see _decode_impl's clamp)
        self.seq_lens[i] = 0
        self.tokens[i] = 0
        self._host_dirty = True   # host seq_lens/tokens diverge from device

    def step(self, burst: int = 1) -> int:
        """Admit + one batched decode burst. Returns the number of active
        slots.

        ``burst > 1`` runs that many greedy decode steps before the host
        reads their tokens (power-of-two clamped); admission and retirement
        happen between bursts, so a larger burst trades scheduling
        granularity for fewer host waits. Requires the default greedy
        sampler: a custom ``sample_fn`` (host callable) forces single
        steps.
        """
        if burst > 1 and self._greedy:
            return self._step_burst(burst)
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        # grow page tables for slots about to write position seq_len
        for i in active:
            if not self.alloc.ensure(i, int(self.seq_lens[i]) + 2,
                                     self.page_size):
                self._retire(i)  # out of pages: finish the sequence
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        logits = _decode_impl(
            self.params, self.cfg, self._upload(self.tokens),
            self._upload(self.seq_lens), self._ctx_table(2),
            self.cache.k_pages, self.cache.v_pages, self.page_size,
            kv_layout=self.kv_layout)
        self.decode_steps += 1
        self._host_dirty = True   # single-step path keeps host-side state
        next_tokens = torch.as_tensor(self.sample_fn(logits)).cpu().numpy()
        for i in active:
            req = self.slots[i]
            self.seq_lens[i] += 1
            tok = int(next_tokens[i])
            req.out_tokens.append(tok)
            self.tokens[i] = tok
            if (len(req.out_tokens) >= req.max_new_tokens or
                    (req.eos_token_id is not None
                     and tok == req.eos_token_id)):
                self._retire(i)
        return len([s for s in self.slots if s is not None])

    def _dispatch_burst(self, burst: int, lookahead: int = 0):
        """Admit + dispatch one burst WITHOUT reading its tokens.
        Returns (toks_device, n, [(slot, request)]), or None if nothing is
        active. ``lookahead`` reserves page capacity for that many extra
        positions beyond the burst (speculative pipelining)."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return None
        # shrink the burst until every active slot has page capacity for
        # all of it; a slot that cannot even fit one more position retires
        # (out of pages), matching the single-step path
        n = burst
        for i in list(active):
            while n > 1 and not self.alloc.ensure(
                    i, int(self.seq_lens[i]) + n + lookahead + 1,
                    self.page_size):
                n //= 2
            if not self.alloc.ensure(i, int(self.seq_lens[i]) + 2,
                                     self.page_size):
                self._retire(i)  # out of pages: finish the sequence
        live = [(i, self.slots[i]) for i in range(self.max_slots)
                if self.slots[i] is not None]
        if not live:
            return None
        n = 1 << (n.bit_length() - 1)        # power-of-two bursts
        if self._host_dirty or self._d_tokens is None:
            d_tokens = self._upload(self.tokens)
            d_lens = self._upload(self.seq_lens)
        else:
            # steady state: chain off the previous burst's device carry
            d_tokens, d_lens = self._d_tokens, self._d_seq_lens
        toks, last, lens = _decode_burst_impl(
            self.params, self.cfg, d_tokens, d_lens,
            self._ctx_table(n + lookahead + 1),
            self.cache.k_pages, self.cache.v_pages, self.page_size, n,
            kv_layout=self.kv_layout)
        self.decode_steps += n
        self._d_tokens, self._d_seq_lens = last, lens
        self._host_dirty = False
        return toks, n, live

    def _absorb_burst(self, toks, n, live) -> int:
        """Read a dispatched burst's tokens (the host's one wait for the
        device) and do the bookkeeping. Slots retired since dispatch
        (pipelined mode) are skipped: their speculative tokens are
        discarded."""
        toks = toks.cpu().numpy()
        for i, req in live:
            if self.slots[i] is not req:
                continue      # retired while this burst was in flight
            for j in range(n):
                tok = int(toks[i, j])
                req.out_tokens.append(tok)
                self.seq_lens[i] += 1
                self.tokens[i] = tok
                if (len(req.out_tokens) >= req.max_new_tokens or
                        (req.eos_token_id is not None
                         and tok == req.eos_token_id)):
                    self._retire(i)
                    break
        return len([s for s in self.slots if s is not None])

    def _step_burst(self, burst: int) -> int:
        out = self._dispatch_burst(burst)
        if out is None:
            return 0
        return self._absorb_burst(*out)

    def _may_speculate(self, n: int, inflight_tokens: int = 0) -> bool:
        """Safe to dispatch the next burst before absorbing the in-flight
        ones? Requires: greedy sampling (already checked), no pending
        admissions (an admission would reuse pages/slots the in-flight
        bursts still reference), and page capacity on every active slot
        for the ``inflight_tokens`` already speculated plus a full extra
        burst (the host ``seq_lens`` are stale by ``inflight_tokens``)."""
        if self.pending:
            return False
        if self._host_dirty or self._d_tokens is None:
            return False  # device carry is stale; next dispatch would
            # re-upload host state that predates the in-flight burst
        for i, r in enumerate(self.slots):
            if r is not None and not self.alloc.ensure(
                    i, int(self.seq_lens[i]) + inflight_tokens + n + 1,
                    self.page_size):
                return False
        return True

    def run(self, max_steps: int = 10000, burst: int = 1,
            pipeline: bool = False, pipeline_depth: int = 2
            ) -> List[Request]:
        """Drive until all submitted requests finish.

        ``pipeline=True`` (burst > 1, greedy only) dispatches burst k+1 off
        the device-resident carry BEFORE reading burst k's tokens, so the
        host's read and bookkeeping overlap device work; ``pipeline_depth``
        keeps up to that many unread bursts in flight. Slots that finish
        mid-flight still decode the speculative bursts (their tokens are
        discarded at absorb); admissions and page capacity force sync
        boundaries. Token streams are exactly the sequential engine's at
        any depth.
        """
        steps = 0
        if pipeline and burst > 1 and self._greedy:
            inflight: List = []   # oldest first
            while (inflight or self.pending
                    or any(s is not None for s in self.slots)) \
                    and steps < max_steps:
                # fill the pipeline up to depth unabsorbed bursts
                while len(inflight) < max(pipeline_depth, 1) \
                        and steps < max_steps:
                    if not inflight:
                        out = self._dispatch_burst(burst)
                        steps += 1
                        if out is None:
                            break
                        inflight.append(out)
                        continue
                    ahead = sum(n for _, n, _ in inflight)
                    if not self._may_speculate(inflight[-1][1], ahead):
                        break
                    out = self._dispatch_burst(inflight[-1][1],
                                               lookahead=ahead)
                    steps += 1
                    if out is None:
                        break
                    inflight.append(out)
                if inflight:
                    self._absorb_burst(*inflight.pop(0))
            out = self.finished
            self.finished = []
            return out
        while (self.pending or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step(burst)
            steps += 1
        out = self.finished
        self.finished = []
        return out
