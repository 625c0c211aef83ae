"""Paged KV cache: fixed-size pages, per-sequence page tables and decode
attention (counterpart of ``any4_tpu/serving/kv_cache.py``).

Layouts are the JAX package's, so the two compare like with like:

- one page pool per layer, ``[n_kv, num_pages, page_size, head_dim]``; an
  int8 pool is an ``(int8 codes, f32 scales [n_kv, num_pages, page_size])``
  pair, with ``code = rint(x * 127.5 / amax)`` saturated to [-128, 127] and
  ``scale = amax`` per token and head;
- a page table ``[slots, pages_per_seq] int32`` maps each slot's logical
  pages to physical ones (:class:`PageAllocator`, host-side numpy);
- the contiguous layout is the same pool with slot ``i`` owning pages
  ``[i*pps, (i+1)*pps)``, so its region is one run of positions.

:func:`write_tokens` writes **in place** into the pools, where the JAX
package returns updated copies of donated buffers.

Decode attention has two kernels, :func:`flash_paged_decode` and
:func:`flash_contig_decode`, each over f32/bf16 pools and over int8 pools:
four CUDA entry points in ``ops/csrc/flash_decode.cu``, which replace the
TPU kernels ``_flash_decode_kernel``/``_flash_decode_kernel_q`` and
``_flash_contig_kernel``/``_flash_contig_kernel_q`` of
``any4_tpu/serving/kv_cache.py``. Their bound on the H100 is bytes: the
live context's K and V rows read once. To keep those bytes in flight on
enough SMs, each kernel splits every slot's context into runs of
:func:`split_len` tokens, one block each, and the last split of each
(slot, head) to finish combines the splits' partial softmaxes in split
order; inside a split, ``cp.async`` keeps the next tile's copies in flight
while one tile is computed. The
split length depends on the batch and head counts only, so the CPU's plain
versions (:func:`_attend_plain`) cut the context at the same places.
Given CPU tensors a wrapper computes its plain PyTorch version; given CUDA
tensors it launches its kernel or raises, and adds one to
``LAUNCHES[name]``. The dense paths (:func:`_dense_attend`,
:func:`_dense_attend_q8`) are plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..ops import build

# quantization_utils.MAX_INT8 of jax.experimental.pallas.ops.tpu
# .paged_attention: int8 pools store code = rint(x * 127.5/amax) with
# scales = amax, so dequant multiplies by amax/127.5
MAX_INT8 = 127.5
_INV_MAX_INT8 = 1.0 / MAX_INT8

# tokens per contiguous-layout block of the TPU kernel; the engine rounds a
# contiguous slot region up to whole blocks of this size
CONTIG_BLOCK_TOKENS = 512
# The next two are the JAX package's dense-or-flash crossovers. They were
# measured on a TPU and are not facts about Hopper; the CUDA dispatch reads
# neither (every context goes to the kernels) until they are re-derived on
# the H100 against a dense path.
CONTIG_FLASH_MIN_CTX = 2048
DENSE_CTX_BYTES = 256 * 1024 * 1024

LAUNCHES = {"flash_paged_decode": 0, "flash_paged_decode_q8": 0,
            "flash_contig_decode": 0, "flash_contig_decode_q8": 0}
_SOURCE = "flash_decode.cu"
_COUNTERS = {}  # (device, stream) -> int32 zeros for the kernels' tickets
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
MAX_HEAD_DIM = 256
_TILE = 64                  # context tokens per online-softmax step
# split_len: at least one block per H100 SM (132) at a 2048-token context
_SPLIT_MIN_BLOCKS = 132
_SPLIT_REF_CTX = 2048
_SPLIT_MAX = 2048


def split_len(b: int, h: int) -> int:
    """Tokens per context split of the decode kernels for ``b`` slots and
    ``h`` kv heads: the largest ``64 * 2^j`` (at most ``_SPLIT_MAX``) that
    still gives ``b * h * ceil(2048 / S) >= 132`` blocks, one per H100 SM,
    or 64 (512 at the 1B engine's b=8, h=8; 64 at b=1). It depends on
    nothing else (not the bucket, the lengths or the device), so a wrapper
    and its plain version cut the context at the same places."""
    s = _TILE
    while s < _SPLIT_MAX and b * h * -(-_SPLIT_REF_CTX // (2 * s)) \
            >= _SPLIT_MIN_BLOCKS:
        s *= 2
    return s


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def to_int8(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``rint(x * (127.5 / h))`` as int8. XLA's float-to-int8 conversion
    saturates and PyTorch's wraps, so the codes are clamped to
    [-128, 127] first: the element equal to ``+h`` rounds to 128 and must
    store 127, not -128. ``127.5 / h`` is one division, as in XLA (PyTorch
    computes ``scalar / tensor`` as a reciprocal times the scalar, which
    rounds twice)."""
    inv = h.new_tensor(MAX_INT8) / h
    return torch.round(x * inv).clamp_(-128, 127).to(torch.int8)


def from_int8(x: torch.Tensor, h: torch.Tensor,
              dtype=torch.bfloat16) -> torch.Tensor:
    """``x.to(dtype) * h / 127.5`` (a bf16 code times f32 scales is f32, as
    in JAX)."""
    return x.to(dtype) * h / MAX_INT8


@dataclass
class PagedKVCache:
    k_pages: List   # per layer [n_kv, P, ps, hd], or (int8 pages, scales)
    v_pages: List
    page_size: int
    quantized: bool = False

    @classmethod
    def create(cls, cfg, num_pages: int, page_size: int = 16, dtype=None,
               quantize: bool = False, device="cuda"):
        """Zeroed pools on ``device``. ``quantize=True`` stores int8 codes
        with per-token f32 scales ``[n_kv, P, ps]`` (initialised to 1)."""
        dtype = dtype or cfg.dtype
        shape = (cfg.num_key_value_heads, num_pages, page_size, cfg.head_dim_)
        n = cfg.num_hidden_layers

        def mk():
            if quantize:
                return (torch.zeros(shape, dtype=torch.int8, device=device),
                        torch.ones(shape[:-1], dtype=torch.float32,
                                   device=device))
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls([mk() for _ in range(n)], [mk() for _ in range(n)],
                   page_size, quantize)


class PageAllocator:
    """Host-side physical-page free list + per-slot page tables."""

    def __init__(self, num_pages: int, max_seqs: int, pages_per_seq: int,
                 contiguous: bool = False):
        # incremented on every table mutation, so the engine re-uploads the
        # device copy of `table` only when it changed
        self.version = 0
        self.pages_per_seq = pages_per_seq
        self.contiguous = contiguous
        if contiguous:
            # each slot owns the fixed page range [i*pps, (i+1)*pps): the
            # table is preassigned and never mutates, and no sink page is
            # needed (a retired slot's stale positions are masked by seq_len
            # and overwritten on reuse)
            if num_pages < max_seqs * pages_per_seq:
                raise ValueError(f"contiguous layout needs {max_seqs} x "
                                 f"{pages_per_seq} pages, got {num_pages}")
            self.free = []
            self.table = np.arange(
                max_seqs * pages_per_seq, dtype=np.int32).reshape(
                max_seqs, pages_per_seq)
            self.seq_pages: List[List[int]] = [
                list(self.table[i]) for i in range(max_seqs)]
            return
        # page 0 is reserved as a scratch sink: inactive slots' page tables
        # are all-zero, so their (masked, never-read) decode writes land
        # there instead of corrupting live pages
        self.free = list(range(num_pages - 1, 0, -1))
        self.table = np.zeros((max_seqs, pages_per_seq), np.int32)
        self.seq_pages = [[] for _ in range(max_seqs)]

    def ensure(self, slot: int, seq_len: int, page_size: int) -> bool:
        """Allocate pages so `seq_len` positions fit. False if OOM."""
        need = -(-seq_len // page_size) if seq_len else 0
        if self.contiguous:
            return need <= self.pages_per_seq
        pages = self.seq_pages[slot]
        while len(pages) < need:
            if not self.free or len(pages) >= self.pages_per_seq:
                return False
            p = self.free.pop()
            self.table[slot, len(pages)] = p
            pages.append(p)
            self.version += 1
        return True

    def release(self, slot: int):
        if self.contiguous:
            return      # preassigned ranges never move
        if self.seq_pages[slot]:
            self.version += 1
        self.free.extend(reversed(self.seq_pages[slot]))
        self.seq_pages[slot] = []
        self.table[slot] = 0


def write_tokens(pages, kv: torch.Tensor, page_ids: torch.Tensor,
                 offsets: torch.Tensor) -> None:
    """Write per-slot new tokens into the page pool, in place.

    pages: ``[h, P, ps, d]`` (or an ``(int8 pages, scales [h, P, ps])``
    pair); kv: ``[b, t, h, d]`` new values; page_ids/offsets: ``[b, t]``
    physical page and in-page offset per token. Entries of padding and of
    inactive slots point at page 0, the scratch sink of the paged layout.

    Decode (``t == 1``) and prefill (``t > 1``) take the same single
    ``index_copy_`` on the flat ``[h, P*ps, d]`` view; the JAX package
    splits them (per-slot ``dynamic_update_slice`` against one scatter)
    only to steer XLA's buffer layouts. Targets repeat only in the sink,
    whose values are never read unmasked.
    """
    if isinstance(pages, tuple):        # int8-quantized pool
        codes, scales = pages
        xf = kv.float()
        amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
        write_tokens(codes, to_int8(xf, amax), page_ids, offsets)
        _write_scales(scales, amax[..., 0], page_ids, offsets)
        return
    b, t, h, d = kv.shape
    flat = pages.view(h, -1, d)                       # [h, P*ps, d]
    idx = (page_ids.long() * pages.shape[2] + offsets.long()).reshape(-1)
    flat.index_copy_(1, idx, kv.permute(2, 0, 1, 3).reshape(h, b * t, d)
                     .to(flat.dtype))


def _write_scales(scales: torch.Tensor, amax: torch.Tensor,
                  page_ids: torch.Tensor, offsets: torch.Tensor) -> None:
    """Write per-token dequant scales into the ``[h, P, ps]`` scale pool,
    in place. amax: ``[b, t, h]``."""
    b, t, h = amax.shape
    flat = scales.view(h, -1)                         # [h, P*ps]
    idx = (page_ids.long() * scales.shape[2] + offsets.long()).reshape(-1)
    flat.index_copy_(1, idx, amax.permute(2, 0, 1).reshape(h, b * t)
                     .to(flat.dtype))


def gather_ctx_hmajor(pages, table: torch.Tensor) -> torch.Tensor:
    """Dense ``[h, b, max_ctx, d]`` context view gathered from the page pool
    (``table [b, pages_per_seq]``). Dequantizes int8 pools."""
    if isinstance(pages, tuple):
        g = gather_ctx_hmajor(pages[0], table).float()
        sc = gather_scales_hmajor(pages[1], table)
        return from_int8(g, sc[..., None], dtype=torch.bfloat16)
    h, P, ps, d = pages.shape
    b, pps = table.shape
    g = pages[:, table.reshape(-1).long()]            # [h, b*pps, ps, d]
    return g.reshape(h, b, pps * ps, d)


def gather_scales_hmajor(scales: torch.Tensor,
                         table: torch.Tensor) -> torch.Tensor:
    """``[h, b, max_ctx]`` view of the ``[h, P, ps]`` scale pool."""
    h, P, ps = scales.shape
    b, pps = table.shape
    return scales[:, table.reshape(-1).long()].reshape(h, b, pps * ps)


def gather_ctx(pages, table: torch.Tensor) -> torch.Tensor:
    """Dense ``[b, max_ctx, h, d]`` context view (test/debug convenience)."""
    return gather_ctx_hmajor(pages, table).permute(1, 2, 0, 3)


def _contig_ctx_view(pages, b: int, ctx_bucket: int):
    """Dense ``[h, b, ctx_bucket, d]`` view of a contiguous-slot pool (a
    reshape and a slice, no copy). Dequantizes int8 pools."""
    if isinstance(pages, tuple):
        g = _contig_ctx_view(pages[0], b, ctx_bucket).float()
        sc = _contig_ctx_view(pages[1], b, ctx_bucket)
        return from_int8(g, sc[..., None], dtype=torch.bfloat16)
    if pages.dim() == 3:                              # [h, P, ps] scale pool
        return pages.reshape(pages.shape[0], b, -1)[:, :, :ctx_bucket]
    h, P, ps, d = pages.shape
    return pages.reshape(h, b, P * ps // b, d)[:, :, :ctx_bucket]


# ------------------------------------------------------------ flash kernels

def _check_flash(name, q, k, v, seq_lens) -> bool:
    """Validate a flash call on any device; True for int8 pools."""
    quantized = isinstance(k, tuple)
    if quantized != isinstance(v, tuple):
        raise ValueError(f"{name}: K and V pools must both be int8 or not")
    kc = k[0] if quantized else k
    if quantized and kc.dtype != torch.int8:
        raise ValueError(f"{name}: quantized codes must be int8")
    if kc.dtype not in _POOL_DTYPES:
        raise ValueError(f"{name}: pool dtype {kc.dtype} is not one of "
                         f"{_POOL_DTYPES}")
    b, nq, d = q.shape
    h = kc.shape[0]
    if nq % h or d != kc.shape[-1]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pool "
                         f"{tuple(kc.shape)}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of 8 and "
                         f"at most {MAX_HEAD_DIM}")
    if seq_lens.shape != (b,):
        raise ValueError(f"{name}: seq_lens must be [{b}]")
    return quantized


def _attend_plain(q, k, v, ks, vs, seq_lens, q_dtype, p_dtype, split):
    """Decode attention with the flash kernels' rounding points, splits and
    online softmax. ``q [h, b, rep, d]`` f32, scaled (and rounded where the
    kernel rounds it); ``k/v [h, b, ctx, d]`` f32; ``ks/vs [h, b, ctx]`` or
    None; ``p_dtype`` the type the probabilities are rounded to before the
    PV product, or None.

    The context is cut into splits of ``split`` tokens (a multiple of
    ``_TILE``) from position 0. Each split runs the online softmax over its
    ``_TILE``-token tiles from ``m = -1e30, l = 0``; the splits that start
    before a slot's length combine in split order against their largest m,
    ``sum acc e^(m - M) / max(sum l e^(m - M), 1e-30)``. With one split that
    is ``acc / max(l, 1e-30)`` bit for bit. Positions ``>= seq_len`` add
    exact zeros, so a slot of length 0 gives 0 and the result does not
    depend on the bucket."""
    h, b, rep, d = q.shape
    ctx = k.shape[2]
    dev = q.device
    pos = torch.arange(ctx, device=dev)
    lens = seq_lens.to(dev)[:, None]
    big_m = torch.full((h, b, rep, 1), -math.inf, device=dev)
    parts = []
    for s0 in range(0, max(ctx, 1), split):
        m = torch.full((h, b, rep, 1), -1e30, device=dev)
        l = torch.zeros((h, b, rep, 1), device=dev)
        acc = torch.zeros((h, b, rep, d), device=dev)
        for t0 in range(s0, min(s0 + split, ctx), _TILE):
            t = slice(t0, t0 + _TILE)
            s = torch.einsum("hbrd,hbcd->hbrc", q, k[:, :, t])
            if ks is not None:
                s = s * (ks[:, :, t] * _INV_MAX_INT8)[:, :, None, :]
            live = (pos[t][None, :] < lens)[None, :, None, :]
            m_new = torch.maximum(m, torch.where(live, s, -1e30).amax(
                dim=-1, keepdim=True))
            p = torch.where(live, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            if vs is not None:  # after l: the denominator stays unscaled
                p = p * (vs[:, :, t] * _INV_MAX_INT8)[:, :, None, :]
            if p_dtype is not None:
                p = p.to(p_dtype).float()
            acc = acc * alpha + torch.einsum("hbrc,hbcd->hbrd", p, v[:, :, t])
            m = m_new
        on = (s0 < lens)[None, :, :, None]              # [1, b, 1, 1]
        big_m = torch.where(on, torch.maximum(big_m, m), big_m)
        parts.append((on, m, l, acc))
    num = torch.zeros((h, b, rep, d), device=dev)
    den = torch.zeros((h, b, rep, 1), device=dev)
    for on, m, l, acc in parts:
        w = torch.where(on, torch.exp(m - big_m), 0.0)
        num = num + acc * w
        den = den + l * w
    out = num / den.clamp_min(1e-30)
    return out.permute(1, 0, 2, 3).reshape(b, h * rep, d).to(q_dtype)


def flash_paged_decode_plain(q, k_pages, v_pages, seq_lens, table,
                             split=None):
    """The paged kernels' function in plain PyTorch: q, K and V (int8 codes
    too) in f32, f32 dots, int8 scales folded into the logits and (after
    the denominator) the probabilities, over splits of ``split`` tokens
    (default :func:`split_len`, the kernels' own)."""
    quantized = isinstance(k_pages, tuple)
    kc, vc = (k_pages[0], v_pages[0]) if quantized else (k_pages, v_pages)
    b, nq, d = q.shape
    h = kc.shape[0]
    qs = q.reshape(b, h, nq // h, d).permute(1, 0, 2, 3).float() \
        * (1.0 / math.sqrt(d))
    ks = vs = None
    if quantized:
        ks = gather_scales_hmajor(k_pages[1], table)
        vs = gather_scales_hmajor(v_pages[1], table)
    return _attend_plain(qs, gather_ctx_hmajor(kc, table).float(),
                         gather_ctx_hmajor(vc, table).float(), ks, vs,
                         seq_lens, q.dtype, None, split or split_len(b, h))


def flash_contig_decode_plain(q, k_pool, v_pool, seq_lens, ctx_bucket,
                              max_ctx, split=None):
    """The contiguous kernels' function in plain PyTorch: ``q * scale`` is
    rounded to the pool's compute type (bf16 for bf16 and int8 pools, f32
    for f32 pools), the QK product accumulates in f32, int8 scales fold
    into the logits and the probabilities, and the probabilities are
    rounded to the compute type before the f32-accumulated PV product;
    splits as in :func:`flash_paged_decode_plain`."""
    quantized = isinstance(k_pool, tuple)
    kc, vc = (k_pool[0], v_pool[0]) if quantized else (k_pool, v_pool)
    b, nq, d = q.shape
    h = kc.shape[0]
    cdt = torch.float32 if kc.dtype == torch.float32 else torch.bfloat16

    def view(p):
        return p[:, :b * max_ctx].reshape(h, b, max_ctx, *p.shape[2:])[
            :, :, :ctx_bucket]
    qs = (q.reshape(b, h, nq // h, d).permute(1, 0, 2, 3).float()
          * (1.0 / math.sqrt(d))).to(cdt).float()
    ks = vs = None
    if quantized:
        ks, vs = view(k_pool[1]), view(v_pool[1])
    return _attend_plain(qs, view(kc).to(cdt).float(),
                         view(vc).to(cdt).float(), ks, vs, seq_lens,
                         q.dtype, cdt, split or split_len(b, h))


def _launch(name, q, k, v, seq_lens, table, ps, pps, max_ctx, ctx_bucket):
    """Launch one of the four entry points of ``flash_decode.cu``."""
    dev = q.device
    quantized = isinstance(k, tuple)
    kc, vc = (k[0], v[0]) if quantized else (k, v)
    ks, vs = (k[1], v[1]) if quantized else (None, None)
    b, nq, d = q.shape
    h = kc.shape[0]
    rep = nq // h
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: q dtype {q.dtype} must be float32 or "
                         f"bfloat16")
    operands = [("q", q), ("k", kc), ("v", vc), ("seq_lens", seq_lens)]
    operands += [("k scales", ks), ("v scales", vs)] if quantized else []
    operands += [("table", table)] if table is not None else []
    for nm, t in operands:
        if t.device != dev:
            raise ValueError(f"{name}: {nm} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} must be 16-byte aligned")
    for nm, t in [("seq_lens", seq_lens), ("table", table)]:
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{name}: {nm} must be int32")
    if quantized and (ks.dtype != torch.float32 or vs.dtype != torch.float32
                      or ks.numel() != kc.numel() // d
                      or vs.numel() != vc.numel() // d):
        raise ValueError(f"{name}: scales must be f32, one per token and "
                         f"head")
    tokens = kc.numel() // (h * d)                    # positions per head
    code = _DTYPE_CODES.get(kc.dtype, 2)
    split = split_len(b, h)
    smem = _smem_bytes(code, table is not None, rep, d, split, ps)
    if smem < 0:
        raise ValueError(f"{name}: rep={rep}, d={d} needs {-smem} bytes of "
                         f"shared memory, more than a Hopper block may use")
    out = torch.empty_like(q)
    if b == 0:
        return out
    limit = pps * ps if table is not None else ctx_bucket
    splits = max(1, -(-limit // split))
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = counters = None
    if splits > 1:
        # each split's (m [rep], l [rep], acc [rep, d]) in f32
        scratch = torch.empty(b * h * splits * rep * (d + 2),
                              dtype=torch.float32, device=dev)
        counters = _counters(dev, stream, b * h)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = getattr(build.load(_SOURCE), name)(
        ptr(q), ptr(kc), ptr(ks), ptr(vc), ptr(vs), ptr(seq_lens), ptr(table),
        ptr(out), b, h, rep, d, tokens, ps, pps, max_ctx, ctx_bucket,
        ctypes.c_float(1.0 / math.sqrt(d)), code, _DTYPE_CODES[q.dtype],
        split, ptr(scratch), ptr(counters), stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _counters(dev, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for the kernels' split tickets, one
    buffer per device and stream: the last split of each (slot, head) sets
    its counter back to 0, so the buffer is zeroed once, and launches on
    one stream never overlap."""
    buf = _COUNTERS.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[(dev, stream)] = torch.zeros(n, dtype=torch.int32,
                                                     device=dev)
    return buf


@functools.lru_cache(maxsize=None)
def _smem_bytes(pool_code, paged, rep, d, split, ps) -> int:
    """Shared memory one launch asks for, from ``flash_decode.cu`` itself
    (negative when it does not fit a block)."""
    return build.load(_SOURCE).flash_decode_smem_bytes(
        pool_code, int(paged), rep, d, split, ps)


def _require_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")


def flash_paged_decode(q: torch.Tensor, k_pages, v_pages,
                       seq_lens: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Paged flash decode for any head_dim (a multiple of 8, at most 256):
    ``q [b, nq, d]`` -> ``[b, nq, d]`` over the pools ``[h, P, ps, d]`` (or
    int8 ``(codes, scales [h, P, ps])`` pairs), ``seq_lens [b]`` and
    ``table [b, pps]`` int32. Positions past ``pps * ps`` are not
    attended."""
    quantized = _check_flash("flash_paged_decode", q, k_pages, v_pages,
                             seq_lens)
    if q.device.type == "cpu":
        return flash_paged_decode_plain(q, k_pages, v_pages, seq_lens, table)
    name = "flash_paged_decode_q8" if quantized else "flash_paged_decode"
    _require_cuda(name, q)
    kc = k_pages[0] if quantized else k_pages
    if table.dim() != 2 or table.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: table must be [b, pages_per_seq]")
    return _launch(name, q, k_pages, v_pages, seq_lens, table, kc.shape[2],
                   table.shape[1], 0, 0)


def flash_contig_decode(q: torch.Tensor, k_pool, v_pool,
                        seq_lens: torch.Tensor, ctx_bucket: int,
                        max_ctx: int) -> torch.Tensor:
    """Flash decode over a contiguous-slot pool ``[h, slots * max_ctx, d]``
    (or int8 ``(codes, scales [h, slots * max_ctx])`` pairs), where slot
    ``i`` owns positions ``[i*max_ctx, i*max_ctx + ctx_bucket)`` that take
    part. ``q [b, nq, d]`` -> ``[b, nq, d]``."""
    quantized = _check_flash("flash_contig_decode", q, k_pool, v_pool,
                             seq_lens)
    kc = k_pool[0] if quantized else k_pool
    if kc.dim() != 3 or not 0 < ctx_bucket <= max_ctx \
            or kc.shape[1] < q.shape[0] * max_ctx:
        raise ValueError(f"flash_contig_decode: pool {tuple(kc.shape)} does "
                         f"not hold {q.shape[0]} slots of {max_ctx} with a "
                         f"bucket of {ctx_bucket}")
    if q.device.type == "cpu":
        return flash_contig_decode_plain(q, k_pool, v_pool, seq_lens,
                                         ctx_bucket, max_ctx)
    name = "flash_contig_decode_q8" if quantized else "flash_contig_decode"
    _require_cuda(name, q)
    return _launch(name, q, k_pool, v_pool, seq_lens, None, 0, 0, max_ctx,
                   ctx_bucket)


# --------------------------------------------------------------- dispatch

def _impl(impl, q, quantized, scale, softcap, window):
    """The attention route: gemma2 options and ``impl="dense"`` go dense; on
    CUDA the kernels take every context and pool type; on the CPU quantized
    pools go dense and the others to the flash plain version, as the JAX
    package routes off the TPU."""
    if scale is not None or softcap is not None or window is not None:
        return "dense"
    if impl not in ("", "dense", "flash"):
        raise ValueError(f"impl must be '', 'dense' or 'flash', got {impl!r}")
    if impl:
        return impl
    return "dense" if quantized and q.device.type != "cuda" else "flash"


def contig_attention(q: torch.Tensor, k_pages, v_pages,
                     seq_lens: torch.Tensor, table: torch.Tensor,
                     impl: str = "", scale=None, softcap=None,
                     window=None) -> torch.Tensor:
    """Decode attention over the contiguous slot layout
    (``PageAllocator(contiguous=True)``); ``table`` only conveys the context
    bucket (its width in pages)."""
    quantized = isinstance(k_pages, tuple)
    kp = k_pages[0] if quantized else k_pages
    b = q.shape[0]
    h, P, ps, d = kp.shape
    ctx_bucket = table.shape[1] * ps
    max_ctx = P * ps // b
    if _impl(impl, q, quantized, scale, softcap, window) == "dense":
        if quantized:
            # int8 pools: the per-token scales fold into the logits/probs
            return _dense_attend_q8(
                q,
                _contig_ctx_view(k_pages[0], b, ctx_bucket),
                _contig_ctx_view(k_pages[1], b, ctx_bucket),
                _contig_ctx_view(v_pages[0], b, ctx_bucket),
                _contig_ctx_view(v_pages[1], b, ctx_bucket),
                seq_lens, scale=scale, softcap=softcap, window=window)
        return _dense_attend(q, _contig_ctx_view(k_pages, b, ctx_bucket),
                             _contig_ctx_view(v_pages, b, ctx_bucket),
                             seq_lens, scale=scale, softcap=softcap,
                             window=window)

    def flat(p):
        if isinstance(p, tuple):
            return (p[0].view(h, P * ps, d), p[1].view(h, P * ps))
        return p.view(h, P * ps, d)
    return flash_contig_decode(q, flat(k_pages), flat(v_pages), seq_lens,
                               ctx_bucket, max_ctx)


def paged_attention(q: torch.Tensor, k_pages, v_pages,
                    seq_lens: torch.Tensor, table: torch.Tensor,
                    scale=None, softcap=None, window=None,
                    impl: str = "") -> torch.Tensor:
    """Paged decode attention: ``q [b, nq, d]`` -> ``[b, nq, d]``. Routes as
    :func:`contig_attention` does; the JAX package's TPU-only routes (its
    dense-below-``DENSE_CTX_BYTES`` choice and the upstream Pallas kernel)
    go to :func:`flash_paged_decode` here."""
    quantized = isinstance(k_pages, tuple)
    if _impl(impl, q, quantized, scale, softcap, window) == "flash":
        return flash_paged_decode(q, k_pages, v_pages, seq_lens, table)
    return _dense_paged_attention(q, k_pages, v_pages, seq_lens, table,
                                  scale=scale, softcap=softcap,
                                  window=window)


def _dense_paged_attention(q, k_pages, v_pages, seq_lens, table,
                           scale=None, softcap=None, window=None):
    """Gather a dense context view and attend with plain PyTorch ops. int8
    pools gather codes and scales separately and fold the scales into the
    logits/probs (:func:`_dense_attend_q8`)."""
    if isinstance(k_pages, tuple):
        return _dense_attend_q8(
            q,
            gather_ctx_hmajor(k_pages[0], table),
            gather_scales_hmajor(k_pages[1], table),
            gather_ctx_hmajor(v_pages[0], table),
            gather_scales_hmajor(v_pages[1], table),
            seq_lens, scale=scale, softcap=softcap, window=window)
    return _dense_attend(q, gather_ctx_hmajor(k_pages, table),
                         gather_ctx_hmajor(v_pages, table), seq_lens,
                         scale=scale, softcap=softcap, window=window)


def _attn_mask(ctx_len: int, seq_lens: torch.Tensor, window=None):
    """Additive decode mask ``[1, b, 1, ctx]``: positions < seq_len visible;
    with ``window`` (gemma2 sliding layers) only the last ``window``
    positions (query position = seq_len - 1, HF ``q - k < window``)."""
    ctx_pos = torch.arange(ctx_len, device=seq_lens.device)[None, None,
                                                             None, :]
    lens = seq_lens[None, :, None, None]
    vis = ctx_pos < lens
    if window is not None:
        vis &= ctx_pos > (lens - 1 - window)
    return torch.where(vis, 0.0, -1e9)


def _softmax_attend(q, kctx, vctx, seq_lens, scale, softcap, window,
                    ks=None, vs=None):
    """Shared body of the dense paths: grouped-head GQA dots over
    ``[h, b, ctx, d]`` views with f32 accumulation; int8 scales fold into
    the logits and the probabilities."""
    b, nq, d = q.shape
    h = kctx.shape[0]
    qh = q.reshape(b, h, nq // h, d).permute(1, 0, 2, 3)   # [h, b, rep, d]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs = qh * scale
    if ks is not None:
        qs = qs.to(torch.bfloat16)
    # int8 codes are exact in bf16, and a product of two bf16 values is
    # exact in f32, so f32 einsums give bf16 dots with f32 accumulation
    logits = torch.einsum("hbrd,hbcd->hbrc", qs.float(), kctx.float())
    if ks is not None:
        logits = logits * (ks * _INV_MAX_INT8)[:, :, None, :]
    if softcap is not None:  # gemma2 attn_logit_softcapping, pre-mask
        logits = softcap * torch.tanh(logits / softcap)
    probs = torch.softmax(logits + _attn_mask(kctx.shape[2], seq_lens,
                                              window), dim=-1)
    if vs is not None:
        probs = probs * (vs * _INV_MAX_INT8)[:, :, None, :]
    cdt = torch.bfloat16 if vs is not None else vctx.dtype
    out = torch.einsum("hbrc,hbcd->hbrd", probs.to(cdt).float(),
                       vctx.float())
    return out.permute(1, 0, 2, 3).reshape(b, nq, d).to(q.dtype)


def _dense_attend_q8(q, kc, ks, vc, vs, seq_lens, scale=None, softcap=None,
                     window=None):
    """:func:`_dense_attend` over int8 code views ``[h, b, ctx, d]`` and
    per-token scales ``[h, b, ctx]``. The dequant ``code * amax / 127.5``
    is linear with a per-token constant, so the K scales multiply the
    logits after the QK product and the V scales the probabilities before
    the PV product; both products run on bf16 operands (codes are exact in
    bf16) with f32 accumulation."""
    return _softmax_attend(q, kc, vc, seq_lens, scale, softcap, window,
                           ks=ks, vs=vs)


def _dense_attend(q, kctx, vctx, seq_lens, scale=None, softcap=None,
                  window=None):
    """Decode attention over a dense ``[h, b, ctx, d]`` context view:
    ``q * scale`` in q's dtype, f32 logits, softmax with the additive
    -1e9 mask, the probabilities cast to the view's dtype, f32 PV
    accumulation, output in q's dtype."""
    return _softmax_attend(q, kctx, vctx, seq_lens, scale, softcap, window)
