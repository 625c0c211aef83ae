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

On a CUDA engine a decode step is a replay of a CUDA graph
(:class:`DecodeGraphs`), one per (slot count, page-table bucket) of the
engine's pools, captured at the key's first decode and taking its greedy
argmax with it, so the host launches one graph where the forward launched
hundreds of kernels and ops; the tokens are the eager step's, bit for bit.
A step runs eagerly instead on the CPU, under tensor parallelism (its gloo
all-reduces cannot be captured), and for a key not yet captured while
``torch.profiler`` records (it is captured at its next untraced decode).
:meth:`Engine._decode` is the one decode path of ``step`` and the bursts.

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

Tensor parallelism: pass ``mesh`` and ``param_spec`` (from
:func:`..parallel.tp.shard_params`, whose shards are ``params``) and every
rank of the mesh's tp group runs its own engine on the same requests, as
one. The forwards take the rank's head counts (``tp.local_config``), the KV
pools hold its kv heads, and the partial outputs of o/down (and of the
MoE combine) are summed by ``torch.distributed.all_reduce`` inside the
prefill, the decode step and the burst (``tp_group``), where the JAX
package runs ``psum`` under ``shard_map``. The logits come out whole on
every rank, so every rank samples the same tokens and schedules alike;
that is checked, not assumed: each read of sampled tokens all-reduces
them over the group first and raises if a rank disagrees. A dp > 1 mesh
makes dp independent replicas, each its own tp group.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import llama, mixtral
from ..models.generate import _check_device, _model_forward
from ..ops import gemv
from ..ops import linear as lin
from ..tracing import recording, span
from . import kv_cache as kvc


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [t] int32
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    out_tokens: list = field(default_factory=list)
    done: bool = False
    # host clock (time.perf_counter) at submit and where its prefill began
    t_submit: Optional[float] = None
    t_prefill: Optional[float] = None


def _ffn(layer, cfg, h, tp_group=None):
    """One decode-step layer's dense MLP, or its routed MoE FFN with dense
    dispatch (see the module docstring)."""
    if mixtral.is_moe(layer):
        return mixtral.moe_ffn(layer, cfg, h, dispatch="dense",
                               tp_group=tp_group)
    return llama.mlp(layer, h, act=cfg.hidden_act, tp_group=tp_group)


def _prefill_impl(params, cfg, prompt, true_len, k_pages, v_pages,
                  table_row, page_size, kv_layout="paged", tp_group=None):
    """Run one bucket-padded prompt ``[1, L]`` and write its first
    ``true_len`` positions of KV into the pools, in place. Returns the last
    real position's logits ``[vocab]``. ``tp_group``: one rank's shards
    (the module docstring)."""
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
        cache_pos=None, mask=mask, tp_group=tp_group)
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
    with span("any4.kv.write"):
        for li in range(cfg.num_hidden_layers):
            kc, vc = caches[li]
            kvc.write_tokens(k_pages[li], kc, page_ids[None], offsets[None])
            kvc.write_tokens(v_pages[li], vc, page_ids[None], offsets[None])
    return logits[0, true_len - 1]


def _decode_impl(params, cfg, tokens, seq_lens, tables, k_pages, v_pages,
                 page_size, kv_layout="paged", tp_group=None):
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
        with span("any4.model.attn"):
            h = llama.rms_norm(x, layer["input_layernorm"], eps, off)
            q, k, v = llama.qkv(layer, cfg, h)
            q = llama.apply_rope(q.reshape(b, 1, nq, hd), cos, sin)
            k = llama.apply_rope(k.reshape(b, 1, nkv, hd), cos, sin)
            v = v.reshape(b, 1, nkv, hd)
            with span("any4.kv.write"):
                kvc.write_tokens(k_pages[li], k, page_ids, offsets)
                kvc.write_tokens(v_pages[li], v, page_ids, offsets)
            # the new token was just written at position seq_len, so the
            # visible length is seq_len + 1
            out = attn(q[:, 0], k_pages[li], v_pages[li], seq_lens + 1,
                       tables, scale=attn_scale, softcap=softcap,
                       window=(cfg.sliding_window if cfg.is_sliding(li)
                               else None))
            out = llama.row_parallel(out.to(x.dtype).reshape(b, 1, nq * hd),
                                     layer["o_proj"], layer.get("o_bias"),
                                     tp_group)
            if cfg.sandwich_norms:  # gemma2: norm attn/ffn outputs, then add
                out = llama.rms_norm(out, layer["post_attention_layernorm"],
                                     eps, off)
            x = x + out
        with span("any4.model.ffn"):
            if cfg.sandwich_norms:
                h = llama.rms_norm(x, layer["pre_feedforward_layernorm"],
                                   eps, off)
                m = _ffn(layer, cfg, h, tp_group)
                x = x + llama.rms_norm(m, layer["post_feedforward_layernorm"],
                                       eps, off)
            else:
                h = llama.rms_norm(x, layer["post_attention_layernorm"], eps,
                                   off)
                x = x + _ffn(layer, cfg, h, tp_group)

    with span("any4.model.head"):
        logits = llama.head(params, llama.rms_norm(x, params["norm"], eps,
                                                   off))
        if cfg.final_logit_softcapping is not None:  # gemma2
            cap = cfg.final_logit_softcapping
            logits = (cap * torch.tanh(logits.float() / cap)).to(
                logits.dtype)
        return logits[:, -1, :]


def _decode_burst_impl(decode, tokens, seq_lens, n_steps):
    """``n_steps`` greedy decode steps for all slots, each feeding its
    on-device argmax to the next; ``decode(tokens, seq_lens)`` is one
    step's ``(logits, argmax)`` (:meth:`Engine._decode`), over a page table
    fixed for the burst (the scheduler reserves ``n_steps`` positions per
    slot). Returns ``(tokens [b, n_steps], last [b], lens [b])`` on the
    device: the final (token, seq_len) carry lets the next burst start
    without an upload."""
    out = []
    for _ in range(n_steps):
        # a copy: the next replay of a captured step overwrites its output
        tokens = decode(tokens, seq_lens)[1].clone()
        seq_lens = seq_lens + 1
        out.append(tokens)
    return torch.stack(out, dim=1), tokens, seq_lens


def captures_decode(device, tp_group) -> bool:
    """Does an engine on ``device`` replay its decode steps from CUDA
    graphs? Not on the CPU, nor under tensor parallelism, whose gloo
    all-reduces cannot be captured."""
    return device.type == "cuda" and tp_group is None


# the port's launch counters, one dict of kernel names each
LAUNCH_COUNTERS = (gemv.LAUNCHES, kvc.LAUNCHES)


def launch_delta(counters, before):
    """The launches of each kernel name that ``counters`` (dicts) counted
    since ``before`` (copies of them), where not 0, one dict a counter."""
    return [{k: n - b.get(k, 0) for k, n in c.items() if n != b.get(k, 0)}
            for c, b in zip(counters, before)]


def credit_launches(counters, delta):
    """Add ``delta`` (:func:`launch_delta`) to ``counters``, in place."""
    for c, d in zip(counters, delta):
        for k, n in d.items():
            c[k] += n


@dataclass
class _Graph:
    """One captured decode step: its static inputs and outputs, the
    launches a replay makes and the buffers of the kernels' modules whose
    addresses it holds."""
    graph: torch.cuda.CUDAGraph
    tokens: torch.Tensor
    seq_lens: torch.Tensor
    table: torch.Tensor
    table_src: torch.Tensor     # the page table last copied into ``table``
    logits: torch.Tensor = None
    argmax: torch.Tensor = None
    launches: list = None
    buffers: list = None


class DecodeGraphs:
    """The CUDA graphs of one engine's decode step (:meth:`Engine._decode`),
    one a key (slot count, page-table bucket).

    A key's graph is captured on a stream of its own, after the step has
    run there eagerly: that run is the decode's result, and it grows the
    kernels' per-stream buffers (``gemv.stream_buffers``,
    ``kv_cache.stream_buffers``) outside the capture. Each graph keeps
    those buffers alive, so a later capture that regrows them frees nothing
    an older graph writes. The graphs share one memory pool: they never run
    at the same time. A replay copies the tokens and lengths into the
    graph's static inputs, the page table only when ``_ctx_table`` gives
    another one, and adds the launches counted at capture to the port's
    counters, since it launches them again."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}

    def replay(self, key, tokens, seq_lens, table):
        g = self.graphs[key]
        g.tokens.copy_(tokens)
        g.seq_lens.copy_(seq_lens)
        if g.table_src is not table:
            g.table.copy_(table)
            g.table_src = table
        g.graph.replay()
        credit_launches(LAUNCH_COUNTERS, g.launches)
        return g.logits, g.argmax

    def capture(self, key, step, tokens, seq_lens, table):
        """Run ``step`` on these inputs on the capture stream, then capture
        it as ``key``'s graph; returns the run's outputs."""
        g = _Graph(torch.cuda.CUDAGraph(), tokens.clone(), seq_lens.clone(),
                   table.clone(), table)
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = step(tokens, seq_lens, table)
            before = [dict(c) for c in LAUNCH_COUNTERS]
            g.graph.capture_begin(pool=self.pool)
            try:
                g.logits, g.argmax = step(g.tokens, g.seq_lens, g.table)
            finally:
                # the capture launched nothing: its counts go to replays
                g.launches = launch_delta(LAUNCH_COUNTERS, before)
                for c, b in zip(LAUNCH_COUNTERS, before):
                    c.update(b)
                g.graph.capture_end()
        cur.wait_stream(self.stream)
        g.buffers = (gemv.stream_buffers(self.stream)
                     + kvc.stream_buffers(self.stream))
        self.graphs[key] = g
        return out


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
        be. ``mesh`` and ``param_spec``: tensor parallelism (the module
        docstring); ``cfg`` stays the whole model's."""
        if kv_layout not in ("contig", "paged"):
            raise ValueError(f"kv_layout must be 'contig' or 'paged', got "
                             f"{kv_layout!r}")
        if (mesh is None) != (param_spec is None):
            raise ValueError("the tensor-parallel engine needs mesh and the "
                             "param_spec of tp.shard_params together")
        self.device = _check_device(params, device)
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        self.tp_group = None
        self._cfg_run = cfg         # the config the forwards run with
        if mesh is not None:
            from ..parallel import tp
            tp.check_shards(params, param_spec)
            self._cfg_run = tp.local_config(cfg, mesh.tp)
            self.tp_group = mesh.tp_group if mesh.tp > 1 else None
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
        self.cache = kvc.PagedKVCache.create(self._cfg_run, num_pages,
                                             page_size, quantize=kv_quantize,
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
        # the decode step's CUDA graphs (_decode)
        self._graphs = (DecodeGraphs(self.device)
                        if captures_decode(self.device, self.tp_group)
                        else None)
        self.decode_steps = 0                  # batched steps dispatched
        # how each of them ran: replayed, captured (and run), or eagerly
        self.graph_replays = self.graph_captures = self.eager_decodes = 0

    def _upload(self, a) -> torch.Tensor:
        """A host array as a tensor on the engine's device. The copy
        ``np.array`` makes keeps later host updates out of it, and a CUDA
        upload goes through pinned memory without waiting for queued
        work."""
        t = torch.from_numpy(np.array(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _read_tokens(self, toks: torch.Tensor) -> np.ndarray:
        """Sampled tokens on the host. Under tensor parallelism they are
        first all-reduced over the tp group (the maximum of ``toks`` and of
        ``-toks`` in one call), and a rank whose tokens differ from the
        group's raises: every rank must schedule the same way."""
        if self.tp_group is None:
            return toks.cpu().numpy()
        t = toks.to(torch.int64)
        both = torch.stack([t, -t])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.tp_group)
        mine, hi, neg_lo = torch.stack([t, both[0], both[1]]).cpu().numpy()
        if (hi != mine).any() or (-neg_lo != mine).any():
            raise RuntimeError("tensor-parallel ranks sampled different "
                               "tokens")
        return mine

    def _decode_eager(self, tokens, seq_lens, table):
        logits = _decode_impl(
            self.params, self._cfg_run, tokens, seq_lens, table,
            self.cache.k_pages, self.cache.v_pages, self.page_size,
            kv_layout=self.kv_layout, tp_group=self.tp_group)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    def _decode(self, tokens, seq_lens, table):
        """One decode step over every slot (:func:`_decode_impl`), each
        slot's new K/V written into the pools: ``(logits [b, vocab], argmax
        [b] int32)``.

        Replayed from the step's CUDA graph of its key (:class:`DecodeGraphs`)
        on a CUDA engine without a tp group; the key's first decode while no
        profiler records captures it, and a decode while one does runs
        eagerly. A replay's outputs are the graph's own, which its next
        replay overwrites: the caller reads or copies them first."""
        self.decode_steps += 1
        key = (tokens.shape[0], table.shape[1])
        g = self._graphs
        action = "eager"
        if g is not None:
            if key in g.graphs:
                action = "replay"
            elif not recording():
                action = "capture"
        with span("any4.engine.graph",
                  {"bucket": table.shape[1], "action": action}):
            if action == "replay":
                self.graph_replays += 1
                return g.replay(key, tokens, seq_lens, table)
            if action == "capture":
                self.graph_captures += 1
                return g.capture(key, self._decode_eager, tokens, seq_lens,
                                 table)
            self.eager_decodes += 1
            return self._decode_eager(tokens, seq_lens, table)

    # ----------------------------------------------------------- requests
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None) -> int:
        self._uid += 1
        self.pending.append(Request(self._uid, np.asarray(prompt, np.int32),
                                    max_new_tokens, eos_token_id,
                                    t_submit=time.perf_counter()))
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
        if not self.pending:
            return
        with span("any4.engine.admit"):
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
                req.t_prefill = time.perf_counter()
                with span("any4.engine.prefill",
                          {"uid": req.uid, "len": t, "bucket": L}):
                    padded = np.zeros(L, np.int32)
                    padded[:t] = req.prompt
                    last_logits = _prefill_impl(
                        self.params, self._cfg_run, self._upload(padded[None]),
                        min(t, L), self.cache.k_pages, self.cache.v_pages,
                        self._upload(self.alloc.table[i]), self.page_size,
                        kv_layout=self.kv_layout, tp_group=self.tp_group)
                    newly.append((i, req, self.sample_fn(last_logits[None])))
                self.slots[i] = req
                self.seq_lens[i] = t
            if newly:
                # one host read for the whole admission wave
                with span("any4.engine.read"):
                    vals = self._read_tokens(torch.cat([
                        torch.as_tensor(tok, device=self.device).reshape(-1)
                        for _, _, tok in newly]))
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
        with span("any4.engine.schedule"):
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
            d_tokens = self._upload(self.tokens)
            d_lens = self._upload(self.seq_lens)
            table = self._ctx_table(2)
        with span("any4.engine.decode"):
            logits, argmax = self._decode(d_tokens, d_lens, table)
        self._host_dirty = True   # single-step path keeps host-side state
        with span("any4.engine.read"):
            next_tokens = self._read_tokens(
                argmax if self._greedy else torch.as_tensor(
                    self.sample_fn(logits), device=self.device))
        with span("any4.engine.absorb"):
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
        with span("any4.engine.schedule"):
            active = [i for i, r in enumerate(self.slots) if r is not None]
            if not active:
                return None
            # shrink the burst until every active slot has page capacity for
            # all of it; a slot that cannot even fit one more position
            # retires (out of pages), matching the single-step path
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
            table = self._ctx_table(n + lookahead + 1)
        with span("any4.engine.decode"):
            toks, last, lens = _decode_burst_impl(
                lambda t, lens: self._decode(t, lens, table), d_tokens,
                d_lens, n)
        self._d_tokens, self._d_seq_lens = last, lens
        self._host_dirty = False
        return toks, n, live

    def _absorb_burst(self, toks, n, live) -> int:
        """Read a dispatched burst's tokens (the host's one wait for the
        device) and do the bookkeeping. Slots retired since dispatch
        (pipelined mode) are skipped: their speculative tokens are
        discarded."""
        with span("any4.engine.read"):
            toks = self._read_tokens(toks)
        with span("any4.engine.absorb"):
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
