"""Weight/quantization analysis (counterpart of
``any4_tpu/evals/analyze.py``, the reference analyze.py equivalent).

Per-layer weight statistics (mean/std/min/max/entropy via histogram,
reference analyze.py:30-33,129-140) and quantization-error metrics (MSE of W
and of layer outputs Y under each quantization method, optionally with
calibrated activations; reference analyze.py:241-269), emitted as a CSV plus
an aggregate summary. :func:`write_plots` emits the reference's plots.pdf
equivalent (weight surface / histogram / sample rows per layer +
per-format error summary, analyze.py:143-155,336-395). :func:`diff_models`
compares two models layer by layer on one prompt (the reference diff.py).
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import linear as lin
from ..quant.api import _walk, default_layer_filter


def weight_stats(w: np.ndarray, bins: int = 256) -> Dict[str, float]:
    hist, _ = np.histogram(w, bins=bins)
    p = hist / max(hist.sum(), 1)
    p = p[p > 0]
    entropy = float(-(p * np.log2(p)).sum())
    return {
        "mean": float(w.mean()), "std": float(w.std()),
        "min": float(w.min()), "max": float(w.max()),
        "entropy": entropy,
    }


def _numpy32(w: torch.Tensor) -> np.ndarray:
    return w.detach().float().cpu().numpy()


def quant_error(w: torch.Tensor, fmt: str, group_size: int = 128,
                sample_weight=None, x: Optional[torch.Tensor] = None,
                **kwargs) -> Dict[str, float]:
    """W-space and Y-space MSE for one layer under a quantization method,
    on ``w``'s device."""
    kw = dict(kwargs)
    if fmt == "any4" and sample_weight is not None:
        kw["sample_weight"] = torch.as_tensor(sample_weight,
                                              dtype=torch.float32,
                                              device=w.device)
    qt = lin.quantize_tensor(w, fmt, group_size, **kw)
    wd = lin.dequantize_tensor(qt, dtype=torch.float32)
    w32 = w.float()
    out = {"w_mse": float(torch.mean((wd - w32) ** 2))}
    if x is not None:
        y = x @ w32.T
        yq = x @ wd.T
        out["y_mse"] = float(torch.mean((y - yq) ** 2))
        denom = torch.linalg.norm(y) * torch.linalg.norm(yq)
        out["y_cossim"] = float(torch.sum(y * yq)
                                / torch.clamp(denom, min=1e-12))
    return out


def analyze_model(params: Dict, fmts: List[str] = ("int4", "nf4", "any4"),
                  group_size: int = 128,
                  sample_weights: Optional[Dict] = None,
                  calib_batch: int = 64,
                  out_dir: Optional[str] = None,
                  layer_filter=default_layer_filter,
                  seed: int = 0, progress: bool = False,
                  device="cuda") -> List[Dict]:
    """Per-layer stats + per-format quantization error table, each weight
    quantized on ``device``.

    The Y-space inputs ``x [calib_batch, k]`` are standard normal draws
    from one ``torch.Generator`` on ``device`` seeded with ``seed``, a
    layer's after the one before; the JAX package draws them with
    ``jax.random``, whose numbers differ."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, leaf, _ in _walk(params):
        if not layer_filter(name, leaf):
            continue
        w = leaf.to(device)
        stats = weight_stats(_numpy32(w))
        x = torch.randn((calib_batch, w.shape[1]), generator=gen,
                        device=device, dtype=torch.float32)
        row = {"layer": name, "shape": str(tuple(w.shape)), **stats}
        sw = sample_weights.get(name) if sample_weights else None
        for fmt in fmts:
            kw = dict(kmeans_iters=10) if fmt == "any4" else {}
            g = 32 if fmt == "mx4" else group_size
            err = quant_error(w, fmt, g, sample_weight=sw, x=x, **kw)
            for k, v in err.items():
                row[f"{fmt}_{k}"] = v
        rows.append(row)
        if progress:
            print(f"  analyzed {name}: " +
                  ", ".join(f"{f}_w_mse={row.get(f + '_w_mse'):.3e}"
                            for f in fmts))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "stats.csv")
        if rows:
            with open(path, "w", newline="") as f:
                wcsv = csv.DictWriter(f, fieldnames=list(rows[0]))
                wcsv.writeheader()
                wcsv.writerows(rows)
    return rows


# colorblind-safe categorical order (Okabe-Ito), fixed assignment by
# format; linestyles double-encode identity for CVD/print
_CAT_COLORS = ("#0072B2", "#E69F00", "#009E73", "#CC79A7", "#56B4E9")
_LINESTYLES = ("-", "--", "-.", ":", "-")


def write_plots(params: Dict, rows: List[Dict], out_dir: str,
                layer_filter=default_layer_filter,
                max_layers: int = 8) -> Optional[str]:
    """Emit plots.pdf: per-layer weight surface (diverging, zero-centered),
    value histogram and sample rows, plus a per-format w_mse summary (the
    reference's surface/histogram/row plots, analyze.py:336-395)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "plots.pdf")
    with PdfPages(path) as pdf:
        count = 0
        for name, leaf, _ in _walk(params):
            if not layer_filter(name, leaf) or count >= max_layers:
                continue
            count += 1
            w = _numpy32(leaf)
            fig, axes = plt.subplots(1, 3, figsize=(12.5, 3.4))
            sub = w[:min(256, w.shape[0]), :min(256, w.shape[1])]
            vmax = float(np.abs(sub).max()) or 1.0
            im = axes[0].imshow(sub, aspect="auto", cmap="RdBu_r",
                                vmin=-vmax, vmax=vmax)
            fig.colorbar(im, ax=axes[0], fraction=0.046)
            axes[0].set_title(f"{name} surface", fontsize=9)
            axes[1].hist(w.reshape(-1)[:262144], bins=100,
                         color=_CAT_COLORS[0])
            axes[1].set_title("value histogram", fontsize=9)
            for r in range(min(3, w.shape[0])):
                axes[2].plot(sub[r], lw=0.8, color=_CAT_COLORS[r],
                             linestyle=_LINESTYLES[r], label=f"row {r}")
            axes[2].legend(fontsize=7)
            axes[2].set_title("sample rows", fontsize=9)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)
        # summary: per-layer w_mse by format (log scale)
        fmt_keys = sorted({k[:-len("_w_mse")] for r in rows for k in r
                           if k.endswith("_w_mse")})
        if rows and fmt_keys:
            fig, ax = plt.subplots(figsize=(12.5, 3.8))
            xs = np.arange(len(rows))
            for j, f in enumerate(fmt_keys):
                ys = [r.get(f + "_w_mse", np.nan) for r in rows]
                ax.plot(xs, ys, marker="o", ms=4, lw=1.6,
                        color=_CAT_COLORS[j % len(_CAT_COLORS)],
                        linestyle=_LINESTYLES[j % len(_LINESTYLES)],
                        label=f)
            ax.set_yscale("log")
            ax.set_xticks(xs)
            ax.set_xticklabels([r["layer"] for r in rows], rotation=60,
                               fontsize=6, ha="right")
            ax.set_ylabel("weight MSE")
            ax.legend(fontsize=8)
            ax.set_title("quantization error by layer and format",
                         fontsize=10)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)
    return path


def diff_models(params_a: Dict, params_b: Dict, cfg, input_ids,
                forward_fn=None, out_dir: Optional[str] = None) -> List[Dict]:
    """Per-layer output MSE + cosine similarity between two models on one
    prompt (the reference diff.py:33-172). Uses the calibration capture
    mechanism to collect per-linear inputs of each model; layer outputs are
    compared via the inputs of the *next* consumer, plus final logits.
    ``forward_fn``: the models' forward (default ``llama.forward``; the
    Mixtral and OPT forwards capture too)."""
    from ..models import llama
    forward_fn = forward_fn or llama.forward
    rows = []
    store_a: Dict = {}
    store_b: Dict = {}
    la, _ = forward_fn(params_a, cfg, input_ids, capture=store_a)
    lb, _ = forward_fn(params_b, cfg, input_ids, capture=store_b)
    for name in store_a:
        sa, _, ca = store_a[name]
        sb, _, cb = store_b[name]
        ma = _numpy32(sa) / ca
        mb = _numpy32(sb) / cb
        mse = float(((ma - mb) ** 2).mean())
        denom = np.linalg.norm(ma) * np.linalg.norm(mb)
        cos = float((ma * mb).sum() / max(denom, 1e-12))
        rows.append({"layer": name, "mse": mse, "cossim": cos})
    la = _numpy32(la)
    lb = _numpy32(lb)
    denom = np.linalg.norm(la) * np.linalg.norm(lb)
    rows.append({"layer": "logits",
                 "mse": float(((la - lb) ** 2).mean()),
                 "cossim": float((la * lb).sum() / max(denom, 1e-12))})
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "diffs.csv"), "w", newline="") as f:
            wcsv = csv.DictWriter(f, fieldnames=["layer", "mse", "cossim"])
            wcsv.writeheader()
            wcsv.writerows(rows)
    return rows
