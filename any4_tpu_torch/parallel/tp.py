"""Tensor and data parallelism over ``torch.distributed`` process groups
(counterpart of ``any4_tpu/parallel/tp.py``).

Every rank of a ``dp x tp`` world holds its own shards and runs the
ordinary forward on them (Megatron-style):

- q/k/v/gate/up (and the fused ``qkv_proj``/``gateup_proj``, Mixtral's
  ``w1``/``w3``/``w13``) are **column-parallel**: a rank holds ``n/tp``
  output rows, so its attention heads and FFN neurons. A
  :class:`~..ops.linear.QuantizedTensor` splits ``packed`` and a per-row
  LUT on axis 0 and the ``[groups, n]`` scales and zeros on axis 1: the
  port's layout keeps one weight row per packed row.
- o/down (Mixtral's ``w2``) are **row-parallel**: a rank holds ``k/tp``
  input columns and computes a partial product; ``torch.distributed
  .all_reduce`` over the tp group sums the partials in float32
  (``tp_group`` of :func:`..models.llama.forward`), where the JAX package
  runs ``lax.psum`` on bf16 partials. A quantized weight must be packed per k segment
  (``quantize_model(row_parallel_shards=S)`` with ``S % tp == 0``, or
  segments with no padding) so that a rank's slice is whole segments.
- norms, embeddings, the LM head and the router are replicated; the KV
  cache holds the rank's kv heads.
- The batch is split over dp and the logits are gathered (the JAX
  package's ``out_specs``), by ``all_gather`` over the dp group.

Ranks are numbered ``rank = dp_index * tp + tp_index``: tp ranks are
contiguous, so under ``torchrun`` a tp group stays on one host
(:mod:`.distributed`). A spec is a tuple of axis names, one per tensor
dimension (``("tp", None)``: split on axis 0 over tp), and a quantized
weight's spec is a :class:`~..ops.linear.QuantizedTensor` of such tuples,
as the JAX package's ``PartitionSpec`` trees.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models import llama
from ..ops import linear as lin
from ..ops import packing
from ..quant.api import _copy_tree, _walk

# column-parallel leaves shard the output dim, row-parallel ones the input
# dim; w1/w3/w2 are Mixtral's per-expert gate/up/down, each expert split on
# its FFN dim like a dense MLP
_COL_KEYS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
             "qkv_proj", "gateup_proj", "w1", "w3", "w13")
_ROW_KEYS = ("o_proj", "down_proj", "w2")
# biases of column-parallel projections split with the output dim; a
# row-parallel projection's bias is replicated and divided by tp at shard
# time, so that the all-reduce adds it once
_COL_BIAS_KEYS = ("q_bias", "k_bias", "v_bias", "qkv_bias", "gate_bias",
                  "up_bias", "gateup_bias")
_ROW_BIAS_KEYS = ("o_bias", "down_bias")
_FUSED_KEYS = ("qkv_proj", "gateup_proj", "w13")
# formats whose TPU words hold two or four weight rows: the JAX package
# refuses a fused reshard whose chunks split a word, and so does the port
_PAIR_FMTS = ("int4p", "int8p")
_QUAD_FMTS = ("w4a8", "w8a8q", "int8q", "any4q8")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``dp x tp`` world: its indices, the process
    groups of its tp ranks (one dp index) and of its dp ranks (one tp
    index), and the device its shards live on."""
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    tp_group: object
    dp_group: object
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}


def make_mesh(dp: int = 1, tp: Optional[int] = None,
              device="cuda") -> Mesh:
    """The ``dp x tp`` mesh of the initialized world (``tp`` defaults to
    world / dp). Every rank must call it, in the same order as its other
    group creations: it creates one group per tp row and per dp column."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if tp is None:
        tp = world // dp
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"dp*tp={dp * tp} != world size {world}")
    tp_groups = [dist.new_group(list(range(i * tp, (i + 1) * tp)))
                 for i in range(dp)]
    dp_groups = [dist.new_group(list(range(j, world, tp)))
                 for j in range(tp)]
    return Mesh(dp, tp, rank // tp, rank % tp, tp_groups[rank // tp],
                dp_groups[rank % tp], torch.device(device))


def _kind(name: str) -> str:
    last = name.split(".")[-1]
    if last in _COL_KEYS or last in _COL_BIAS_KEYS:
        return "col"
    if last in _ROW_KEYS:
        return "row"
    return "repl"


def _qt_spec(kind: str, qt: lin.QuantizedTensor) -> lin.QuantizedTensor:
    """The spec of a quantized weight's fields (None where the field is
    None): ``packed [n, kw]`` and a per-row ``lut [n, 16]`` split n on axis
    0, the group arrays ``[groups, n]`` on axis 1; a row-parallel weight
    splits ``packed`` on axis 1 and the group arrays on axis 0, except the
    row-scale formats' ``[1, n]``, which every k slice shares."""
    repl = (None, None)
    per_row = qt.lut is not None and qt.lut.shape[0] == qt.shape[0]
    if kind == "col":
        fields = dict(packed=("tp", None), scales=(None, "tp"),
                      zeros=(None, "tp"),
                      lut=("tp", None) if per_row else repl)
    elif kind == "row":
        groups = repl if qt.fmt in lin.ROWSCALE_FMTS else ("tp", None)
        fields = dict(packed=(None, "tp"), scales=groups, zeros=groups,
                      lut=repl)
    else:
        fields = dict(packed=repl, scales=repl, zeros=repl, lut=repl)
    if qt.lut is None:
        fields["lut"] = None
    return dataclasses.replace(qt, **fields)


def _spec_for(name: str, leaf):
    if leaf is None:
        return None
    kind = _kind(name)
    if isinstance(leaf, lin.QuantizedTensor):
        return _qt_spec(kind, leaf)
    if leaf.ndim == 1 and kind == "col":
        return ("tp",)
    if kind == "repl" or leaf.ndim != 2:
        return (None,) * leaf.ndim
    return ("tp", None) if kind == "col" else (None, "tp")


def param_specs(params: Dict) -> Dict:
    """A tree of the same structure as ``params`` holding each leaf's
    spec."""
    out = _copy_tree(params)
    for name, leaf, setter in _walk(out):
        setter(_spec_for(name, leaf))
    return out


def _interleave_rows(leaf, sizes, tp: int):
    """Permute the output rows of a fused (concatenated) weight so that
    each contiguous 1/tp chunk holds that rank's slice of every part
    (``sizes``: the parts' output dims): a contiguous split of ``[q; k;
    v]`` would give rank 0 only q rows. A row index, since the port keeps
    one weight row per packed row; the JAX package's divisibility checks,
    so that the same trees are accepted and refused."""
    order = []
    offs = np.cumsum([0] + list(sizes[:-1]))
    for i in range(tp):
        for off, sz in zip(offs, sizes):
            if sz % tp:
                raise ValueError(f"fused part {sz} not divisible by tp={tp}")
            per = sz // tp
            order.extend(range(off + i * per, off + (i + 1) * per))
    if not isinstance(leaf, lin.QuantizedTensor):
        return leaf[torch.as_tensor(order, device=leaf.device)]
    for fmts, rows in ((_PAIR_FMTS, 2), (_QUAD_FMTS, 4)):
        if leaf.fmt in fmts and not ((offs % rows == 0).all() and all(
                (sz // tp) % rows == 0 for sz in sizes)):
            raise ValueError(f"{leaf.fmt} packs {rows} rows a TPU word: a "
                             f"fused reshard needs per-shard chunks % "
                             f"{rows} == 0")
    idx = torch.as_tensor(order, device=leaf.packed.device)
    lut = leaf.lut
    if lut is not None and lut.shape[0] == leaf.shape[0]:
        lut = lut[idx]
    return dataclasses.replace(leaf, packed=leaf.packed[idx],
                               scales=leaf.scales[:, idx],
                               zeros=leaf.zeros[:, idx], lut=lut)


def _fused_part_sizes(key: str, cfg) -> Optional[list]:
    if cfg is None:
        return None
    hd = cfg.head_dim_
    if key in ("qkv_proj", "qkv_bias"):
        return [cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd,
                cfg.num_key_value_heads * hd]
    if key in ("gateup_proj", "gateup_bias", "w13"):
        return [cfg.intermediate_size, cfg.intermediate_size]
    return None


def reshard_fused(params: Dict, cfg, tp: int) -> Dict:
    """Interleave the rows of fused qkv/gateup weights (and their biases)
    for a tp-way column split; a copy of the tree, unchanged at tp=1."""
    out = _copy_tree(params)
    if tp == 1:
        return out
    for name, leaf, setter in _walk(out):
        sizes = _fused_part_sizes(name.split(".")[-1], cfg)
        if sizes is not None and leaf is not None:
            setter(_interleave_rows(leaf, sizes, tp))
    return out


def _take(t: torch.Tensor, axis: int, tp: int, r: int) -> torch.Tensor:
    return packing.segments(t, tp, axis=axis)[r]


def _local_qt(qt: lin.QuantizedTensor, kind: str, tp: int,
              r: int) -> lin.QuantizedTensor:
    """Rank ``r``'s shard of a quantized weight, itself a whole weight of
    the rank's shape."""
    n, k = qt.shape
    if kind == "col":
        if n % tp:
            raise ValueError(f"n={n} not divisible by tp={tp}")
        lut = qt.lut
        if lut is not None and lut.shape[0] == n:
            lut = _take(lut, 0, tp, r)
        return dataclasses.replace(
            qt, packed=_take(qt.packed, 0, tp, r),
            scales=_take(qt.scales, 1, tp, r),
            zeros=_take(qt.zeros, 1, tp, r), lut=lut, shape=(n // tp, k))
    S = qt.row_shards
    rowscale = qt.fmt in lin.ROWSCALE_FMTS
    if k % tp:
        raise ValueError(f"k={k} not divisible by tp={tp}")
    if S % tp == 0:
        shards = S // tp
    elif (k // S) % packing.PACK_BLOCK == 0 \
            and (k // tp) % packing.PACK_BLOCK == 0 \
            and (rowscale or (k // tp) % qt.group_size == 0):
        shards = 1          # unpadded segments: any block boundary is one
    else:
        raise ValueError(
            f"a row-parallel weight of k={k} packed in {S} segment(s) "
            f"cannot be split {tp} ways at its padding: quantize it with "
            f"row_parallel_shards a multiple of {tp}")
    groups = (lambda a: a) if rowscale else (lambda a: _take(a, 0, tp, r))
    return dataclasses.replace(
        qt, packed=_take(qt.packed, 1, tp, r), scales=groups(qt.scales),
        zeros=groups(qt.zeros), shape=(n, k // tp), row_shards=shards,
        group_size=k // tp if rowscale else qt.group_size)


def _local(leaf, spec, tp: int, r: int, device):
    """Rank ``r``'s shard of one leaf, contiguous on ``device``."""
    if leaf is None:
        return None

    def put(t):
        return None if t is None else t.contiguous().to(device)

    if isinstance(leaf, lin.QuantizedTensor):
        kind = ("col" if spec.packed[0] == "tp" else
                "row" if spec.packed[1] == "tp" else "repl")
        if kind != "repl":
            leaf = _local_qt(leaf, kind, tp, r)
        return dataclasses.replace(
            leaf, packed=put(leaf.packed), scales=put(leaf.scales),
            zeros=put(leaf.zeros), lut=put(leaf.lut))
    if "tp" in spec:
        leaf = _take(leaf, spec.index("tp"), tp, r)
    return put(leaf)


def shard_params(params: Dict, mesh: Mesh, cfg=None) -> Tuple[Dict, Dict]:
    """This rank's shards of ``params`` on ``mesh.device``, and the specs.
    Returns ``(local_params, specs)``.

    ``cfg`` (the model's config) is required when the tree holds fused
    ``qkv_proj``/``gateup_proj``/``w13`` leaves and tp > 1: their rows are
    interleaved first (:func:`reshard_fused`), since a contiguous split of
    a fused weight is silently wrong. A row-parallel bias is divided by tp.
    """
    tp = mesh.tp
    has_fused = any(name.split(".")[-1] in _FUSED_KEYS
                    for name, _, _ in _walk(params))
    if has_fused and tp > 1:
        if cfg is None:
            raise ValueError(
                "shard_params: fused qkv/gateup weights need cfg= to "
                "interleave-reshard rows for tp>1 (a contiguous split of a "
                "fused weight is silently wrong)")
        params = reshard_fused(params, cfg, tp)
    if tp > 1:
        params = _copy_tree(params)
        for name, leaf, setter in _walk(params):
            if leaf is not None and name.split(".")[-1] in _ROW_BIAS_KEYS:
                setter(leaf / tp)
    specs = param_specs(params)
    local = _copy_tree(params)
    # a spec tuple is a leaf to _walk (it descends into dicts and lists)
    for (_, leaf, setter), (_, spec, _) in zip(_walk(local), _walk(specs)):
        setter(_local(leaf, spec, tp, mesh.tp_rank, mesh.device))
    return local, specs


def check_shards(params: Dict, param_spec: Dict) -> None:
    """Raise ``ValueError`` unless ``params`` has the structure of
    ``param_spec`` (:func:`shard_params`' specs): the same leaves, a
    quantized weight where the spec holds one, and one spec entry for each
    dimension of every tensor."""
    leaves, specs = list(_walk(params)), list(_walk(param_spec))
    if [n for n, _, _ in leaves] != [n for n, _, _ in specs]:
        raise ValueError("params and param_spec hold different leaves")
    for (name, leaf, _), (_, spec, _) in zip(leaves, specs):
        if isinstance(leaf, lin.QuantizedTensor):
            ok = (isinstance(spec, lin.QuantizedTensor)
                  and len(spec.packed) == leaf.packed.ndim)
        elif leaf is None:
            ok = spec is None
        else:
            ok = isinstance(spec, tuple) and len(spec) == leaf.ndim
        if not ok:
            raise ValueError(f"{name}: the leaf does not match its spec "
                             f"{spec!r}")


def local_config(cfg: "llama.LlamaConfig", tp: int) -> "llama.LlamaConfig":
    """A rank's config under column-parallel attention: the head counts
    divided by tp, ``head_dim`` pinned first (a derived ``hidden_size //
    num_attention_heads`` would double)."""
    for what in ("num_attention_heads", "num_key_value_heads"):
        if getattr(cfg, what) % tp:
            raise ValueError(f"{getattr(cfg, what)} {what} not divisible "
                             f"by tp={tp}")
    return dataclasses.replace(
        cfg, num_attention_heads=cfg.num_attention_heads // tp,
        num_key_value_heads=cfg.num_key_value_heads // tp,
        head_dim=cfg.head_dim_)


def make_tp_forward(cfg: "llama.LlamaConfig", mesh: Mesh, param_spec,
                    with_cache: bool = False, forward_fn=None):
    """The tensor-parallel forward of one rank.

    Without a cache: ``fn(params, input_ids [B, t]) -> logits [B, t,
    vocab]``. With one: ``fn(params, token [B], pos, kv_caches) -> (logits
    [B, vocab], kv_caches)``, one decode step at cache position ``pos``;
    the caches are this rank's, ``[B/dp, max_len, n_kv/tp, head_dim]`` a
    layer (``llama.init_kv_caches(local_config(cfg, tp), B // dp, ...)``),
    written in place. ``params`` are this rank's shards
    (:func:`shard_params`, whose specs are ``param_spec``; the first call
    on a tree checks it against them, :func:`check_shards`); every rank
    passes the whole batch, takes its dp slice, and gets the logits of the
    whole batch back. ``forward_fn`` defaults to ``llama.forward``
    (``mixtral.forward`` runs MoE models)."""
    fwd = llama.forward if forward_fn is None else forward_fn
    cfg_local = local_config(cfg, mesh.tp)
    group = mesh.tp_group if mesh.tp > 1 else None
    seen = []       # the trees checked, kept so that no id is reused

    def checked(params):
        if not any(p is params for p in seen):
            check_shards(params, param_spec)
            seen.append(params)
        return params

    def dp_slice(x):
        if x.shape[0] % mesh.dp:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"dp={mesh.dp}")
        per = x.shape[0] // mesh.dp
        return x[mesh.dp_rank * per:(mesh.dp_rank + 1) * per]

    def gather(y):
        if mesh.dp == 1:
            return y
        parts = [torch.empty_like(y) for _ in range(mesh.dp)]
        dist.all_gather(parts, y.contiguous(), group=mesh.dp_group)
        return torch.cat(parts)

    if not with_cache:
        def forward(params, input_ids):
            logits, _ = fwd(checked(params), cfg_local, dp_slice(input_ids),
                            tp_group=group)
            return gather(logits)
        return forward

    def step(params, token, pos, kv_caches):
        checked(params)
        tok = dp_slice(token)
        b, max_len = tok.shape[0], kv_caches[0][0].shape[1]
        positions = torch.full((b, 1), int(pos), dtype=torch.long,
                               device=tok.device)
        logits, caches = fwd(
            params, cfg_local, tok[:, None], positions=positions,
            kv_caches=kv_caches, cache_pos=pos,
            mask=llama.decode_mask(max_len, pos, tok.device), tp_group=group)
        return gather(logits[:, -1, :]), caches
    return step
