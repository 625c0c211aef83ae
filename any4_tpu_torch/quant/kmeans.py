"""Weighted k-means over matrix rows, the any4 LUT learner (counterpart of
``any4_tpu/quant/kmeans.py``).

All rows are clustered at once as batched tensor ops: the E-step is an
argmin over a ``[rows, k, clusters]`` distance tensor, the M-step three
``scatter_add_`` sums per cluster. Rows are processed in chunks whose
distance tensor fits a byte budget (:data:`CHUNK_BYTES`), not in a fixed
number of rows: with a handful of chunks per matrix, quantizing a 1B model
is a few thousand launches, not millions.

Inits: ``k-means++`` (weighted; the default), ``random`` /
``manual_random``, ``int`` (per-row linspace), ``pow`` (per-row geomspace)
and ``nf4`` (the nf4 table rescaled to the row's range). Random inits draw
from an explicit ``torch.Generator``, so their numbers differ from
``jax.random``'s; the deterministic inits give the JAX package's codes and
LUTs up to float32 summation order.
"""
from __future__ import annotations

import heapq
import re
from typing import Optional, Union

import numpy as np
import torch

from ..ops.formats import NF4_TABLE
from ..ops.quant import fma as _fma

# budget for one chunk's [rows, k, clusters] f32 distance tensor
CHUNK_BYTES = 1 << 30


def _linspace01(n_clusters: int, device) -> torch.Tensor:
    # jnp.linspace(0, 1, n) in float32: iota * (1/(n-1)), last entry exact
    t = torch.arange(n_clusters, dtype=torch.float32, device=device) \
        * np.float32(1.0 / (n_clusters - 1))
    t[-1] = 1.0
    return t


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _init_int(x: torch.Tensor, n_clusters: int) -> torch.Tensor:
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    return _fma(hi - lo, _linspace01(n_clusters, x.device)[None, :], lo)


def _init_nf4(x: torch.Tensor, n_clusters: int) -> torch.Tensor:
    if n_clusters != 16:
        raise ValueError("nf4 init requires 16 clusters")
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    t = (torch.as_tensor(NF4_TABLE, device=x.device) + 1.0) / 2.0
    return _fma(hi - lo, t[None, :], lo)


def _init_pow(x: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """Geometric spacing from the row min to the row max; the min is clamped
    to a small epsilon because the any4 domain is ``[0, 2^n-1]``."""
    lo = torch.clamp(x.amin(dim=1, keepdim=True), min=1e-6)
    hi = torch.maximum(x.amax(dim=1, keepdim=True), lo * (1 + 1e-6))
    t = _linspace01(n_clusters, x.device)[None, :]
    return torch.exp(_fma(torch.log(hi) - torch.log(lo), t, torch.log(lo)))


def _init_random(x: torch.Tensor, n_clusters: int,
                 gen: torch.Generator) -> torch.Tensor:
    """``n_clusters`` distinct points of each row, drawn uniformly."""
    r = torch.rand(x.shape, generator=gen, device=x.device)
    idx = torch.topk(r, n_clusters, dim=1).indices
    return torch.gather(x, 1, idx)


def _init_kmeanspp(x: torch.Tensor, weights: torch.Tensor, n_clusters: int,
                   gen: torch.Generator) -> torch.Tensor:
    """Weighted k-means++ seeding, vectorized over rows: the next centroid
    is drawn with probability proportional to ``max(weight * d^2, 1e-30)``,
    ``d`` the distance to the nearest centroid chosen so far."""
    r, k = x.shape
    first = torch.randint(0, k, (r, 1), generator=gen, device=x.device)
    c = torch.gather(x, 1, first)
    dmin = (x - c) ** 2
    cents = [c[:, 0]]
    for _ in range(1, n_clusters):
        p = torch.clamp(weights * dmin, min=1e-30)
        idx = torch.multinomial(p, 1, generator=gen)
        c = torch.gather(x, 1, idx)
        dmin = torch.minimum(dmin, (x - c) ** 2)
        cents.append(c[:, 0])
    return torch.stack(cents, dim=1)


# ---------------------------------------------------------------------------
# Lloyd iterations
# ---------------------------------------------------------------------------

def _assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    d = (x[:, :, None] - cents[:, None, :]) ** 2          # [r, k, c]
    return torch.argmin(d, dim=2)                          # first on ties


def _lloyd(x: torch.Tensor, x_surrogate: torch.Tensor,
           weights: torch.Tensor, cents: torch.Tensor, iters: int):
    """Weighted Lloyd iterations on a row chunk.

    The M-step averages ``x_surrogate`` (equal to ``x`` unless surrogate
    clustering is on) with ``weights``. A cluster whose weights sum to zero
    takes the unweighted mean; an empty cluster keeps its centroid.
    """
    r, c = cents.shape
    for _ in range(iters):
        assign = _assign(x, cents)
        zeros = torch.zeros((r, c), dtype=x.dtype, device=x.device)
        wsum = zeros.clone().scatter_add_(1, assign, weights)
        wnum = zeros.clone().scatter_add_(1, assign, weights * x_surrogate)
        csum = zeros.clone().scatter_add_(1, assign, torch.ones_like(x))
        cnum = zeros.scatter_add_(1, assign, x_surrogate)
        unweighted = torch.where(csum > 0, cnum / torch.clamp(csum, min=1e-30),
                                 cents)
        cents = torch.where(wsum > 0, wnum / torch.clamp(wsum, min=1e-30),
                            unweighted)
    return cents, _assign(x, cents)


def _kmeans_chunk(x, weights, x_surrogate, gen, n_clusters, iters, init):
    if init == "k-means++":
        cents = _init_kmeanspp(x, weights, n_clusters, gen)
    elif init in ("random", "manual_random"):
        cents = _init_random(x, n_clusters, gen)
    elif init == "int":
        cents = _init_int(x, n_clusters)
    elif init == "pow":
        cents = _init_pow(x, n_clusters)
    elif init == "nf4":
        cents = _init_nf4(x, n_clusters)
    else:
        raise ValueError(f"unsupported init {init!r}")
    return _lloyd(x, x_surrogate, weights, cents, iters)


def _kmeans_impl(x, weights, x_surrogate, gen, n_clusters, iters, init,
                 row_chunk):
    r = x.shape[0]
    parts = [_kmeans_chunk(x[i:i + row_chunk], weights[i:i + row_chunk],
                           x_surrogate[i:i + row_chunk], gen, n_clusters,
                           iters, init)
             for i in range(0, r, row_chunk)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def kmeans_rows(x: torch.Tensor, n_clusters: int = 16,
                sample_weight: Optional[torch.Tensor] = None,
                x_surrogate: Optional[torch.Tensor] = None,
                init: str = "k-means++", iters: int = 30,
                generator: Optional[torch.Generator] = None,
                row_chunk: Optional[int] = None,
                n_init: int = 1):
    """Cluster every row of ``x`` ``[n, k]`` into ``n_clusters`` scalar
    centroids.

    Returns ``(centroids [n, n_clusters] f32, assign [n, k] int32)`` with the
    centroids of each row sorted ascending and the codes remapped to match.
    ``sample_weight`` may be ``[k]`` (shared by all rows) or ``[n, k]``.
    ``n_init > 1`` reruns the random inits and keeps, per row, the restart
    with the lowest weighted inertia. ``row_chunk`` (rows per chunk)
    defaults to as many rows as fit :data:`CHUNK_BYTES` of distances.
    """
    x = x.float()
    r, k = x.shape
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    if sample_weight is None:
        weights = torch.ones_like(x)
    else:
        sw = torch.as_tensor(sample_weight, dtype=torch.float32,
                             device=x.device)
        weights = (sw if sw.ndim == 2 else sw[None, :]).expand(r, k)
    surrogate = x if x_surrogate is None else \
        torch.as_tensor(x_surrogate, dtype=torch.float32, device=x.device)
    if row_chunk is None:
        row_chunk = max(1, CHUNK_BYTES // (k * n_clusters * 4))
    row_chunk = min(row_chunk, r)

    def run():
        return _kmeans_impl(x, weights, surrogate, generator, n_clusters,
                            iters, init, row_chunk)

    if n_init > 1 and init in ("k-means++", "random", "manual_random"):
        best = None
        for _ in range(n_init):
            cents, assign = run()
            vals = torch.gather(cents, 1, assign)
            inertia = (weights * (x - vals) ** 2).sum(dim=1)
            if best is None:
                best = (cents, assign, inertia)
            else:
                better = inertia < best[2]
                best = (torch.where(better[:, None], cents, best[0]),
                        torch.where(better[:, None], assign, best[1]),
                        torch.minimum(inertia, best[2]))
        cents, assign = best[0], best[1]
    else:
        cents, assign = run()
    order = torch.argsort(cents, dim=1, stable=True)
    cents_sorted = torch.gather(cents, 1, order)
    inv = torch.argsort(order, dim=1, stable=True)
    return cents_sorted, torch.gather(inv, 1, assign).to(torch.int32)


# ---------------------------------------------------------------------------
# Sample-weight spec parsing
# ---------------------------------------------------------------------------

def build_sample_weight(x: np.ndarray, spec: Union[None, str, np.ndarray],
                        use_abs: bool = True):
    """Parse a sample-weight spec against data ``x`` of shape ``[k]`` or
    ``[k, d]``: an explicit array, ``"outlier_{factor}[_{num}]"`` (upweight
    the ``num`` largest and smallest unique values by ``factor``) or
    ``"gradual_{max}[_{min}][_pow{p}]"`` (weight grows from the midpoint
    outwards). Returns a ``[k]`` numpy array or None."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    if spec is None:
        return None
    if isinstance(spec, (np.ndarray, torch.Tensor)):
        w = np.asarray(spec).squeeze()
        if w.shape != (n,):
            raise ValueError(f"sample_weight shape {w.shape} != ({n},)")
    elif isinstance(spec, str) and spec.startswith("outlier"):
        m = re.match(r"^outlier_([0-9]*\.?[0-9]+)(?:_([0-9]+))?$", spec)
        if not m:
            raise ValueError(f"failed to parse {spec!r}")
        factor = float(m.group(1))
        num = int(m.group(2)) if m.group(2) else 1
        xm = x.mean(axis=1)
        w = np.ones(n)
        uniq = np.unique(xm)
        hi = np.partition(uniq, -num)[-num:]
        lo = np.partition(uniq, num - 1)[:num]
        w[np.isin(xm, hi)] = factor
        w[np.isin(xm, lo)] = factor
    elif isinstance(spec, str) and spec.startswith("gradual"):
        m = re.match(r"^gradual_(-?[0-9]*\.?[0-9]+)(?:_(-?[0-9]*\.?[0-9]+))?"
                     r"(?:_pow(-?[0-9]*\.?[0-9]+))?$", spec)
        if not m:
            raise ValueError(f"failed to parse {spec!r}")
        fmax = float(m.group(1))
        fmin = float(m.group(2)) if m.group(2) else 1.0
        p = float(m.group(3)) if m.group(3) else 1.0
        xm = x.mean(axis=1)
        mid = (xm.max() + xm.min()) / 2
        denom = xm.max() - mid if xm.max() != mid else 1.0
        w = (fmax - fmin) * (np.abs(xm - mid) / denom) ** p + fmin
    else:
        raise ValueError(f"unsupported sample weight spec {spec!r}")
    if use_abs:
        w = np.abs(w)
    return w


# ---------------------------------------------------------------------------
# Agglomerative backend: Ward clustering of each row on the host
# ---------------------------------------------------------------------------

def _ward_labels(v: np.ndarray, n_clusters: int) -> np.ndarray:
    """Ward-linkage labels of the scalars ``v``, cut into ``n_clusters`` as
    scikit-learn's ``AgglomerativeClustering`` cuts its tree (the same
    scipy tree): from the root, ``n_clusters - 1`` times split the cluster
    of the largest node id into its two children, in a heap of negated
    ids whose array order numbers the clusters, so that clusters with
    equal centroids (a row of fewer distinct values than clusters) are
    numbered alike. (scipy's ``cut_tree`` and ``fcluster`` cut rows with
    tied values differently.)"""
    from scipy.cluster.hierarchy import linkage

    k = v.shape[0]
    children = linkage(v.reshape(-1, 1), "ward")[:, :2].astype(np.int64)
    heap = [-(2 * k - 2)]                    # the root
    for _ in range(n_clusters - 1):
        left, right = children[-heap[0] - k]
        heapq.heappush(heap, -left)
        heapq.heappushpop(heap, -right)      # pops the node just split
    labels = np.empty(k, np.int64)
    for c, node in enumerate(heap):
        stack = [-node]
        while stack:
            u = stack.pop()
            if u < k:
                labels[u] = c
            else:
                stack.extend(children[u - k])
    return labels


def agglomerative_rows(x: torch.Tensor, n_clusters: int = 16,
                       sample_weight=None):
    """Per-row agglomerative (Ward) clustering with weighted-average
    centroids, the reference's ``cluster_row_agglomerative``. Rows run one
    at a time on the host (scipy), so this is for small matrices and
    parity experiments; :func:`kmeans_rows` is the production path.

    ``sample_weight`` is ``[k]`` or ``[n, k]``; a cluster whose weights sum
    to 0 takes the unweighted mean. Centroids are averaged in float64.
    Returns ``(centroids [n, n_clusters] f32 sorted ascending, assign
    [n, k] int32)`` on ``x``'s device.
    """
    xs = x.detach().cpu().double().numpy()
    n, k = xs.shape
    sw = None if sample_weight is None else \
        torch.as_tensor(sample_weight).detach().cpu().numpy()
    cents = np.zeros((n, n_clusters), np.float32)
    assign = np.zeros((n, k), np.int32)
    for r in range(n):
        labels = _ward_labels(xs[r], n_clusters)
        row_w = None if sw is None else (sw[r] if sw.ndim == 2 else sw)
        vals = np.empty(n_clusters)
        for c in range(n_clusters):
            m = labels == c
            w = None if row_w is None else row_w[m]
            if w is not None and w.sum() == 0:
                w = None
            vals[c] = np.average(xs[r][m], weights=w)
        order = np.argsort(vals)
        inv = np.empty_like(order)
        inv[order] = np.arange(n_clusters)
        cents[r] = vals[order]
        assign[r] = inv[labels]
    return (torch.from_numpy(cents).to(x.device),
            torch.from_numpy(assign).to(x.device))
