"""lm-evaluation-harness adapter (counterpart of
``any4_tpu/evals/lm_eval_adapter.py``).

The reference's primary NLP-task route is ``lm_eval.simple_evaluate`` over
an HFLM (eval.py:297-321). Here the LM protocol implementation
(:class:`TorchCausalLM`: ``loglikelihood`` / ``loglikelihood_rolling`` /
``generate_until``) is a standalone duck-typed class with NO lm_eval
dependency, so it is fully exercised offline (the local task runner in
:mod:`.tasks_local`); when lm_eval IS installed, :func:`make_lm` wraps it
into the harness's ``LM`` ABC and :func:`simple_evaluate` runs the real task
suite.

The JAX package buckets requests to power-of-two lengths and left-pads
generation prompts so that XLA compiles a bounded number of programs. Here
scoring sorts requests by length and right-pads each batch of
``batch_size`` to its longest request (padding cannot reach earlier
positions under the causal mask), and generation runs the prompt unpadded
through :func:`..models.generate.prefill` and
:func:`..models.generate.decode_step` at batch 1, which gives the tokens
of greedy :func:`..models.generate.generate`. ``MIN_BUCKET`` is kept where
it sets what is generated: the clamp of ``max_gen_toks`` and of the prompt
kept.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import generate as gen
from ..models import llama
from .perplexity import token_logprobs


class LmEvalUnavailable(RuntimeError):
    pass


def _require_lm_eval():
    try:
        import lm_eval  # noqa: F401
        return lm_eval
    except ImportError as e:
        raise LmEvalUnavailable(
            "lm-eval is not installed in this environment") from e


class TorchCausalLM:
    """LM-protocol implementation over the port's functional model.

    Methods take/return the same shapes as lm_eval's ``LM`` interface but
    accept plain ``(context, continuation)`` string tuples (or request
    objects exposing ``.args``), so the class works without lm_eval.
    The forward is ``llama.forward``, or ``mixtral.forward`` for MoE
    layers, as :mod:`..models.generate` picks it (``JaxCausalLM``'s
    ``forward_fn``, which no caller sets, is not kept); ``params`` must
    live on ``device``.
    """

    MIN_BUCKET = 32

    def __init__(self, params, cfg, tokenizer, batch_size: int = 8,
                 max_length: int = 2048, device="cuda"):
        self.device = gen._check_device(params, device)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self._fwd = gen._model_forward(params)

    # ------------------------------------------------------------- helpers
    def _encode(self, text: str) -> List[int]:
        return list(self.tokenizer.encode(text))

    def _score_batch(self, token_lists: Sequence[List[int]]
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Score token sequences (already truncated to max_length).

        Returns per-sequence (logp[t-1], greedy_hit[t-1]) arrays. Sequences
        are sorted by length and batched; right-padding cannot influence
        earlier positions under the causal mask.
        """
        results: List[Optional[Tuple[np.ndarray, np.ndarray]]] = \
            [None] * len(token_lists)
        order = sorted(range(len(token_lists)),
                       key=lambda i: len(token_lists[i]))
        for i in range(0, len(order), self.batch_size):
            batch_idx = order[i:i + self.batch_size]
            L = len(token_lists[batch_idx[-1]])
            ids = np.zeros((len(batch_idx), L), np.int64)
            for r, j in enumerate(batch_idx):
                toks = token_lists[j]
                ids[r, :len(toks)] = toks
            ids = torch.from_numpy(ids).to(self.device)
            logits, _ = self._fwd(self.params, self.cfg, ids)
            lp, hit = token_logprobs(logits, ids[:, 1:])
            lp, hit = lp.cpu().numpy(), hit.cpu().numpy()
            for r, j in enumerate(batch_idx):
                t = len(token_lists[j])
                results[j] = (lp[r, :t - 1], hit[r, :t - 1])
        return results  # type: ignore[return-value]

    @staticmethod
    def _args(req):
        return req.args if hasattr(req, "args") else req

    def _first_token(self) -> List[int]:
        """The context of a request without one: ``[bos]``, else ``[0]``."""
        bos = getattr(self.tokenizer, "bos_token_id", None)
        return [bos] if bos is not None else [0]

    # ------------------------------------------------------ LM interface
    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        pairs = [self._args(r) for r in requests]
        token_lists, ncont = [], []
        for context, continuation in pairs:
            ctx = self._encode(context) or self._first_token()
            cont = self._encode(continuation)
            toks = (ctx + cont)[-self.max_length:]
            token_lists.append(toks)
            ncont.append(min(len(cont), len(toks) - 1))
        out = []
        for (lp, hit), n in zip(self._score_batch(token_lists), ncont):
            if n <= 0:  # empty continuation: lp[-0:] would be the WHOLE
                out.append((0.0, True))  # sequence, not zero tokens
            else:
                out.append((float(lp[-n:].sum()), bool(hit[-n:].all())))
        return out

    def loglikelihood_rolling(self, requests) -> List[float]:
        out = []
        for r in requests:
            (text,) = self._args(r) if isinstance(self._args(r), tuple) \
                else (self._args(r),)
            ids = self._encode(text)
            chunks = []
            for s in range(0, max(len(ids) - 1, 1), self.max_length - 1):
                chunk = ids[s:s + self.max_length]
                if len(chunk) >= 2:
                    chunks.append(chunk)
            total = 0.0
            if chunks:
                for lp, _ in self._score_batch(chunks):
                    total += float(lp.sum())
            out.append(total)
        return out

    # ---------------------------------------------------------- generate
    def greedy_tokens(self, ids: List[int], max_new: int,
                      until: Sequence[str] = ()) -> List[int]:
        """Up to ``max_new`` greedy tokens after the prompt ``ids``: stops
        before the tokenizer's eos and after the token whose decoded text
        holds a stop string of ``until``."""
        eos = getattr(self.tokenizer, "eos_token_id", None)
        prompt = torch.tensor([ids], dtype=torch.long, device=self.device)
        caches = llama.init_kv_caches(self.cfg, 1, len(ids) + max_new,
                                      device=self.device)
        logits, caches = gen.prefill(self.params, self.cfg, prompt, caches)
        toks: List[int] = []
        for i in range(max_new):
            tok = int(torch.argmax(logits.float(), dim=-1)[0])
            if eos is not None and tok == eos:
                break
            toks.append(tok)
            if i + 1 < max_new:
                logits, caches = gen.decode_step(
                    self.params, self.cfg,
                    torch.tensor([tok], dtype=torch.int32,
                                 device=self.device),
                    len(ids) + i, caches)
            text = self.tokenizer.decode(toks)
            if any(stop in text for stop in until):
                break
        return toks

    def generate_until(self, requests) -> List[str]:
        """Greedy continuations, cut at the first stop string. An empty
        context is generated from ``[bos]`` (else ``[0]``), as
        ``loglikelihood`` scores it."""
        out = []
        for r in requests:
            context, kwargs = self._args(r)
            kwargs = dict(kwargs or {})
            until = kwargs.get("until", []) or []
            if isinstance(until, str):
                until = [until]
            max_new = int(kwargs.get("max_gen_toks", 128))
            # keep at least MIN_BUCKET tokens of context: a max_gen_toks
            # >= max_length would otherwise flip the slice sign and take
            # tokens from the FRONT (possibly an empty prompt)
            max_new = min(max_new, self.max_length - self.MIN_BUCKET)
            keep = max(self.max_length - max_new, self.MIN_BUCKET)
            ids = self._encode(context)[-keep:] or self._first_token()
            text = self.tokenizer.decode(self.greedy_tokens(ids, max_new,
                                                            until))
            for stop in until:
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
            out.append(text)
        return out


def make_lm(params, cfg, tokenizer, batch_size: int = 8,
            max_length: int = 2048, device="cuda"):
    """Wrap :class:`TorchCausalLM` into an ``lm_eval.api.model.LM``."""
    _require_lm_eval()
    from lm_eval.api.model import LM

    inner = TorchCausalLM(params, cfg, tokenizer, batch_size=batch_size,
                          max_length=max_length, device=device)

    class TorchLM(LM):
        def loglikelihood(self, requests):
            return inner.loglikelihood(requests)

        def loglikelihood_rolling(self, requests):
            return inner.loglikelihood_rolling(requests)

        def generate_until(self, requests):
            return inner.generate_until(requests)

    return TorchLM()


def simple_evaluate(params, cfg, tokenizer, tasks: List[str],
                    limit: Optional[int] = None, **kwargs) -> dict:
    """Run lm_eval.simple_evaluate against the wrapped model."""
    lm_eval = _require_lm_eval()
    lm = make_lm(params, cfg, tokenizer, **kwargs)
    return lm_eval.simple_evaluate(model=lm, tasks=tasks, limit=limit)
