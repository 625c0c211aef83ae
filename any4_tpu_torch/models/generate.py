"""Greedy and sampled generation with a static KV cache (counterpart of
``any4_tpu/models/generate.py``).

Prefill runs the prompt in one forward that writes the cache; each decode
step is a one-token forward. :func:`decode_loop` is a Python loop over
:func:`decode_step` where the JAX package scans the step inside one
compiled program; every step launches its kernels from the host. The
forward is :func:`.llama.forward`, or :func:`.mixtral.forward` for a tree
of MoE layers (:func:`_model_forward`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import llama, mixtral


def _model_forward(params: Dict):
    """``llama.forward``, or ``mixtral.forward`` when the tree's layers
    carry MoE experts (``experts`` or stacked ``moe_w13``)."""
    if params["layers"] and mixtral.is_moe(params["layers"][0]):
        return mixtral.forward
    return llama.forward


def _prefill_mask(t: int, max_len: int, device) -> torch.Tensor:
    """Causal mask for a prefill writing into a ``[max_len]`` cache."""
    q = torch.arange(t, device=device)[:, None]
    s = torch.arange(max_len, device=device)[None, :]
    return torch.where(s <= q, 0.0, -1e9)[None, None].float()


def _check_device(params: Dict, device) -> torch.device:
    """The device of ``params`` (of ``embed_tokens``, or of its codes when
    it is quantized); raises unless it is of ``device``'s type."""
    device = torch.device(device)
    emb = params["embed_tokens"]
    have = getattr(emb, "packed", emb).device
    if have.type != device.type:
        raise ValueError(f"params are on {have}, generation asked for "
                         f"{device}")
    return have


def prefill(params: Dict, cfg: llama.LlamaConfig, input_ids: torch.Tensor,
            kv_caches):
    """Forward over the prompt, filling the caches. Returns the last
    position's logits ``[b, vocab]`` and the caches."""
    t = input_ids.shape[1]
    max_len = kv_caches[0][0].shape[1]
    logits, caches = _model_forward(params)(
        params, cfg, input_ids, kv_caches=kv_caches, cache_pos=None,
        mask=_prefill_mask(t, max_len, input_ids.device))
    return logits[:, -1, :], caches


def decode_step(params: Dict, cfg: llama.LlamaConfig, token: torch.Tensor,
                pos: int, kv_caches):
    """One decode step; ``token [b]`` is written at cache index ``pos``."""
    b = token.shape[0]
    max_len = kv_caches[0][0].shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=token.device)
    logits, caches = _model_forward(params)(
        params, cfg, token[:, None], positions=positions,
        kv_caches=kv_caches, cache_pos=pos,
        mask=llama.decode_mask(max_len, pos, token.device))
    return logits[:, -1, :], caches


def _pick(logits: torch.Tensor, temperature: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    logits = logits.float()
    if temperature > 0:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def decode_loop(params: Dict, cfg: llama.LlamaConfig, token: torch.Tensor,
                pos: int, kv_caches, n_steps: int, temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                done: Optional[torch.Tensor] = None,
                eos_token_id: Optional[int] = None):
    """``n_steps`` decode steps from ``token`` at cache position ``pos``.

    Returns ``(tokens [b, n_steps], last_logits, pos + n_steps, caches,
    done)``: the tokens for positions ``pos+1 .. pos+n_steps``. Once a row
    has produced ``eos_token_id`` it keeps producing it.
    """
    b = token.shape[0]
    if done is None:
        done = torch.zeros((b,), dtype=torch.bool, device=token.device)
    logits = torch.zeros((b, cfg.vocab_size), dtype=torch.float32,
                         device=token.device)
    toks = []
    tok = token
    for _ in range(n_steps):
        logits, kv_caches = decode_step(params, cfg, tok, pos, kv_caches)
        logits = logits.float()
        nxt = _pick(logits, temperature, generator).to(torch.int32)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        toks.append(nxt)
        tok = nxt
        pos += 1
    tokens = torch.stack(toks, dim=1) if toks else \
        torch.zeros((b, 0), dtype=torch.int32, device=token.device)
    return tokens, logits, pos, kv_caches, done


def generate(params: Dict, cfg: llama.LlamaConfig, prompt_ids,
             max_new_tokens: int = 32, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             eos_token_id: Optional[int] = None,
             device="cuda") -> torch.Tensor:
    """Generate greedily (or sample with ``temperature > 0`` from
    ``generator``). ``prompt_ids [b, t]``; returns ``[b, t +
    max_new_tokens]`` int32 on ``device``, where ``params`` must live."""
    dev = _check_device(params, device)
    prompt_ids = torch.as_tensor(prompt_ids, device=dev).to(torch.int32)
    b, tp = prompt_ids.shape
    caches = llama.init_kv_caches(cfg, b, tp + max_new_tokens, device=dev)
    logits, caches = prefill(params, cfg, prompt_ids.long(), caches)
    tok = _pick(logits, temperature, generator).to(torch.int32)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    if eos_token_id is not None:
        done = tok == eos_token_id
    tokens = [prompt_ids, tok[:, None]]
    if max_new_tokens > 1:
        toks, _, _, caches, done = decode_loop(
            params, cfg, tok, tp, caches, max_new_tokens - 1,
            temperature=temperature, generator=generator, done=done,
            eos_token_id=eos_token_id)
        tokens.append(toks)
    return torch.cat(tokens, dim=1)
