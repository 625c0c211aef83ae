"""Perplexity evaluation over token streams (counterpart of
``any4_tpu/evals/perplexity.py``).

Two evaluators, mirroring the reference's two perplexity paths:

- :func:`eval_perplexity_chunked`: GPTQ-style fixed-seqlen NLL -- concatenate
  the corpus, split into ``[seqlen]`` chunks, average token NLL
  (reference data_gptq.py:195-220 ``llama_eval``).
- :func:`eval_perplexity_stream`: streaming per-document NLL
  (reference data.py:37-130 ``eval_perplexity``): documents are chunked to
  ``seqlen`` and token-weighted.

Both take pre-tokenized ``input_ids`` so they are dataset/tokenizer-agnostic
(dataset loading lives in :mod:`.datasets` and is network-gated). The JAX
package pads every forward to one static shape so that XLA compiles one
program; here each forward runs at its exact shape: a batch of chunks
``[b, seqlen]`` (the last batch may hold fewer), and a streaming window's
``seqlen + 1`` tokens as ``seqlen`` inputs and ``seqlen`` targets (a causal
forward gives the same logits without the last token). The NLL of a target
is ``logsumexp(logits) - logits[target]`` in float32 (:func:`token_logprobs`),
taken over blocks of :data:`NLL_ROWS` positions so that one float32 copy of
a block's logits is held at a time: at vocab 128256 a 2048-token row is
1.05 GB in float32.

The forward is :func:`..models.llama.forward`, or
:func:`..models.mixtral.forward` for a tree of MoE layers, as
:mod:`..models.generate` picks it. Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``; ``params`` must live there.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..models import generate as gen

# positions whose float32 logits are held at once
NLL_ROWS = 512


def token_logprobs(logits: torch.Tensor, targets: torch.Tensor,
                   rows: int = NLL_ROWS):
    """``(log p(target) [b, t] float32, greedy hit [b, t] bool)`` of the
    first ``t`` positions of ``logits [b, T, vocab]`` (``t <= T``) against
    ``targets [b, t]``; each block of ``rows`` positions is cast to float32
    alone."""
    b, t = targets.shape
    lp = torch.empty((b, t), dtype=torch.float32, device=logits.device)
    hit = torch.empty((b, t), dtype=torch.bool, device=logits.device)
    tgt = targets.long()
    for r in range(b):
        for s in range(0, t, rows):
            lf = logits[r, s:min(s + rows, t)].float()
            tg = tgt[r, s:s + rows, None]
            lp[r, s:s + rows] = (lf.gather(1, tg)
                                 - torch.logsumexp(lf, -1, keepdim=True))[:, 0]
            hit[r, s:s + rows] = lf.argmax(-1) == tg[:, 0]
    return lp, hit


def _nll(params: Dict, cfg, inputs: torch.Tensor,
         targets: torch.Tensor) -> float:
    """Summed next-token NLL of ``targets [b, t]`` under the logits of the
    first ``t`` positions of ``inputs [b, T]``."""
    logits, _ = gen._model_forward(params)(params, cfg, inputs)
    lp, _ = token_logprobs(logits, targets)
    return -float(lp.sum())


def eval_perplexity_chunked(params: Dict, cfg, token_stream: np.ndarray,
                            seqlen: int = 2048, batch_size: int = 1,
                            max_chunks: Optional[int] = None,
                            progress: bool = False, device="cuda") -> float:
    """GPTQ-style fixed-seqlen perplexity over a flat token stream."""
    dev = gen._check_device(params, device)
    tokens = np.asarray(token_stream).reshape(-1)
    nchunks = len(tokens) // seqlen
    if max_chunks is not None:
        nchunks = min(nchunks, max_chunks)
    if nchunks <= 0:
        raise ValueError("token stream shorter than one chunk")
    total_nll, total_cnt = 0.0, 0
    for start in range(0, nchunks, batch_size):
        b = min(batch_size, nchunks - start)
        chunk = torch.from_numpy(
            tokens[start * seqlen:(start + b) * seqlen].reshape(b, seqlen)
            .astype(np.int64)).to(dev)
        total_nll += _nll(params, cfg, chunk, chunk[:, 1:])
        total_cnt += b * (seqlen - 1)
        if progress:
            print(f"  ppl chunk {start + b}/{nchunks}: "
                  f"{math.exp(total_nll / total_cnt):.4f}", flush=True)
    return math.exp(total_nll / total_cnt)


def eval_perplexity_stream(params: Dict, cfg, sequences, seqlen: int = 2048,
                           max_samples: Optional[int] = None,
                           device="cuda") -> float:
    """Streaming perplexity over per-document token sequences."""
    dev = gen._check_device(params, device)
    total_nll, total_cnt = 0.0, 0
    for i, seq in enumerate(sequences):
        if max_samples is not None and i >= max_samples:
            break
        seq = np.asarray(seq).reshape(-1)
        for s in range(0, max(len(seq) - 1, 0), seqlen):
            window = seq[s:s + seqlen + 1]
            if len(window) < 2:
                continue
            ids = torch.from_numpy(window.astype(np.int64)[None]).to(dev)
            total_nll += _nll(params, cfg, ids[:, :-1], ids[:, 1:])
            total_cnt += len(window) - 1
    if total_cnt <= 0:
        raise ValueError("no sequence holds two tokens")
    return math.exp(total_nll / total_cnt)
