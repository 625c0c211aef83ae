"""The numbers that decide ``correct``, from the reference's logits.

- ``logit_gap`` (served models): for each token the program served, how
  far its logit lies below the reference's best at that position, the
  widest over a sample of finished requests. The reference runs once over
  each prompt with its served tokens. Valid for greedy tokens.
- ``logit_gap_mean``: the same gaps' mean over the sample. A routed model
  in bf16 picks other experts than the float32 reference wherever a router
  near-tie tips (most positions of a 32-layer Mixtral), which moves those
  positions' logits by up to about 2; the widest gap then reads a tipped
  tie, and the mean reads how often the served token is not the
  reference's best and by how much.
- ``logit_gap_request``: the widest of the sampled requests' mean gaps,
  so that a fault confined to one request is not diluted by the others.
- ``logit_gap_settled@<m>`` (routed models): the widest gap over the
  served positions whose router margin in the reference (its last chosen
  expert's logit above the first one left out) is at least ``m`` in every
  layer, where bf16 should not tip a route; ``settled_positions@<m>``
  counts them.
- ``nll_gap`` (scoring): for each scored window, the distance between
  the program's log-perplexity and the reference's mean negative
  log-likelihood of its targets, the widest over a sample of windows;
  ``nll_gap_mean``: the same distances' mean over the sample.

With ``control`` the same positions are read under the fp8 control
(:class:`.model.Reference` with ``act="fp8"``): the gap of the token the
control puts first, and the control's log-perplexity.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from .model import Reference

ROWS = 512          # positions whose f32 logits are held at once
SETTLED = (0.02, 0.05)  # router margins of the settled positions


def _logits_rows(h: torch.Tensor, head: torch.Tensor, rows=ROWS):
    for s in range(0, h.shape[0], rows):
        yield s, h[s:s + rows] @ head.t()


def _gap_numbers(gaps, margins, prefix=""):
    """The numbers of per-request gaps ``gaps`` (and for a routed model
    the positions' router margins ``margins``), keys under ``prefix``."""
    g = torch.cat(gaps)
    res = {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
           "logit_gap_request": max(float(x.mean()) for x in gaps)}
    if margins is not None:
        m = torch.cat(margins)
        for t in SETTLED:
            keep = g[m >= t]
            res[f"logit_gap_settled@{t}"] = (float(keep.max())
                                             if keep.numel() else None)
            res[f"settled_positions@{t}"] = int(keep.numel())
    return {prefix + k: v for k, v in res.items()}


def logit_gap(config: dict, seed: int, device,
              served: Sequence[tuple], control: bool = False) -> dict:
    """``served``: ``(prompt ids, served ids)`` pairs. Returns
    ``{"logit_gap": x, "logit_gap_mean": y, ...}`` and, with ``control``,
    the same under ``control_``."""
    seqs, spans = [], []
    for prompt, out in served:
        ids = torch.as_tensor(list(prompt) + list(out[:-1]))
        seqs.append(ids)
        spans.append((len(prompt) - 1, torch.as_tensor(list(out))))
    ref = Reference(config, seed, device)
    head = ref.head()
    hs = ref.hidden(seqs)
    margins = ([m[p0:] for m, (p0, _) in zip(ref.min_margin, spans)]
               if ref.min_margin is not None else None)
    cref = Reference(config, seed, device, act="fp8")
    hc = cref.hidden(seqs) if control else [None] * len(hs)
    gaps, cgaps = [], []
    for h, c, (p0, out) in zip(hs, hc, spans):
        rg, rc = [], []
        for s, lg in _logits_rows(h[p0:], head):
            best = lg.max(-1).values
            tok = out[s:s + lg.shape[0]].to(lg.device).long()
            rg.append(best - lg.gather(1, tok[:, None])[:, 0])
            if c is not None:
                pick = cref.logits(c[p0 + s:p0 + s + lg.shape[0]],
                                   head).argmax(-1)
                rc.append(best - lg.gather(1, pick[:, None])[:, 0])
        gaps.append(torch.cat(rg))
        if rc:
            cgaps.append(torch.cat(rc))
    res = _gap_numbers(gaps, margins)
    if control:
        res.update(_gap_numbers(cgaps, margins, "control_"))
    return res


def _mean_nll(ref, h: torch.Tensor, ids: torch.Tensor, head: torch.Tensor):
    tgt = ids[1:].to(h.device).long()
    total = 0.0
    for s in range(0, h.shape[0] - 1, ROWS):
        lg = ref.logits(h[s:min(s + ROWS, h.shape[0] - 1)], head)
        t = tgt[s:s + lg.shape[0]]
        total += float((torch.logsumexp(lg, -1)
                        - lg.gather(1, t[:, None])[:, 0]).sum())
    return total / tgt.numel()


def nll_gap(config: dict, seed: int, device, windows: Sequence,
            perplexities: Sequence[float], control: bool = False) -> dict:
    """``windows``: id arrays; ``perplexities``: the program's answers for
    them. Returns ``{"nll_gap": x, "nll_gap_mean": y}`` and, with
    ``control``, the same under ``control_``."""
    seqs = [torch.as_tensor(w) for w in windows]
    ref = Reference(config, seed, device)
    head = ref.head()
    nll = [_mean_nll(ref, h, s, head)
           for h, s in zip(ref.hidden(seqs), seqs)]
    gaps = [abs(math.log(p) - n) if math.isfinite(p) and p > 0
            else math.inf for p, n in zip(perplexities, nll)]
    res = {"nll_gap": max(gaps), "nll_gap_mean": sum(gaps) / len(gaps)}
    if control:
        cref = Reference(config, seed, device, act="fp8")
        cgaps = [abs(a - b) for a, b in zip(
            (_mean_nll(cref, h, s, head)
             for h, s in zip(cref.hidden(seqs), seqs)), nll)]
        res["control_nll_gap"] = max(cgaps)
        res["control_nll_gap_mean"] = sum(cgaps) / len(cgaps)
    return res
