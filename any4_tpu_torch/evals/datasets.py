"""Dataset loaders for perplexity/eval tasks (network-gated); a copy of
``any4_tpu/evals/datasets.py``, which uses no JAX, kept here because the
port imports nothing of the JAX package.

Mirrors the reference's two dataset families:
- GPTQ-style fixed splits (wikitext-2, ptb, c4, pile) built by concatenating
  the raw corpus and tokenizing once (reference data_gptq.py:19-193);
- streaming HF datasets with per-task configs (reference data.py:13-35
  ``task_dataset_configs``).

Without network access every loader degrades gracefully: if the dataset
(or tokenizer) is unavailable locally, ``load_tokens`` raises
``DatasetUnavailable`` which callers may catch to skip the task. A synthetic
deterministic token stream is provided for plumbing tests and offline
development.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


class DatasetUnavailable(RuntimeError):
    pass


@dataclass(frozen=True)
class DatasetConfig:
    path: str
    name: Optional[str] = None
    split: str = "test"
    field: str = "text"
    join: str = "\n\n"


# reference data_gptq.py:223-229 + data.py:13-35 (subset relevant to ppl)
task_dataset_configs: Dict[str, DatasetConfig] = {
    "wikitext-2": DatasetConfig("wikitext", "wikitext-2-raw-v1", "test"),
    "wikitext-103": DatasetConfig("wikitext", "wikitext-103-raw-v1", "test"),
    "ptb": DatasetConfig("ptb_text_only", "penn_treebank", "test",
                         field="sentence", join=" "),
    "c4": DatasetConfig("allenai/c4", "en", "validation"),
    "c4-new": DatasetConfig("allenai/c4", "en", "validation"),
    "pile": DatasetConfig("mit-han-lab/pile-val-backup", None, "validation"),
    "codeparrot": DatasetConfig("codeparrot/codeparrot-clean-valid", None,
                                "train", field="content"),
    "openwebtext": DatasetConfig("openwebtext", None, "train"),
    "lambada": DatasetConfig("lambada", None, "test"),
    "bookcorpus": DatasetConfig("bookcorpus", None, "train"),
    "tiny-shakespeare": DatasetConfig("tiny_shakespeare", None, "test"),
}


def load_text(task: str, max_chars: Optional[int] = None) -> str:
    cfg = task_dataset_configs.get(task)
    if cfg is None:
        raise ValueError(f"unknown task {task!r}; "
                         f"have {sorted(task_dataset_configs)}")
    try:
        from datasets import load_dataset
        ds = load_dataset(cfg.path, cfg.name, split=cfg.split)
    except Exception as e:  # offline / missing cache
        raise DatasetUnavailable(
            f"dataset {task!r} unavailable (offline?): {e}") from e
    parts = []
    total = 0
    for row in ds:
        t = row[cfg.field]
        parts.append(t)
        total += len(t)
        if max_chars is not None and total >= max_chars:
            break
    return cfg.join.join(parts)


def load_tokens(task: str, tokenizer, max_tokens: Optional[int] = None,
                max_chars: Optional[int] = None) -> np.ndarray:
    """Tokenize a task's corpus into one flat int32 stream (the GPTQ-style
    evaluator input). ``tokenizer`` is any object with ``encode`` or
    ``__call__`` returning input_ids."""
    text = load_text(task, max_chars=max_chars)
    if hasattr(tokenizer, "encode"):
        ids = tokenizer.encode(text)
    else:
        ids = tokenizer(text)["input_ids"]
    ids = np.asarray(ids, dtype=np.int32).reshape(-1)
    if max_tokens is not None:
        ids = ids[:max_tokens]
    return ids


def synthetic_tokens(vocab_size: int, n_tokens: int = 16384,
                     seed: int = 0) -> np.ndarray:
    """Deterministic Zipf-ish synthetic token stream for offline plumbing
    tests (not a language-model benchmark -- perplexities on this are only
    meaningful relative to each other)."""
    rng = np.random.RandomState(seed)
    # Zipfian-like distribution over the vocab with local repetition
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    ids = rng.choice(vocab_size, size=n_tokens, p=probs)
    # inject local structure: repeat previous token 10% of the time
    rep = rng.rand(n_tokens) < 0.1
    for i in range(1, n_tokens):
        if rep[i]:
            ids[i] = ids[i - 1]
    return ids.astype(np.int32)


def _encode(tokenizer, text: str) -> np.ndarray:
    if hasattr(tokenizer, "encode"):
        ids = tokenizer.encode(text)
    else:
        ids = tokenizer(text)["input_ids"]
    return np.asarray(ids, np.int32).reshape(-1)


def seeded_crops(ids: np.ndarray, nsamples: int, seqlen: int,
                 seed: int) -> np.ndarray:
    """The GPTQ calibration crop protocol, rng-exact against the reference
    (data_gptq.py:45-55): ``random.seed(seed)`` then one stdlib
    ``random.randint(0, L - seqlen - 1)`` per sample over the concatenated
    token stream. Using the SAME stdlib Mersenne-Twister sequence (not a
    numpy RandomState) makes calibration sets reproducible bit-for-bit
    against reference runs at equal tokenization."""
    import random
    random.seed(seed)
    L = len(ids)
    out = np.empty((nsamples, seqlen), np.int32)
    for s in range(nsamples):
        i = random.randint(0, L - seqlen - 1) if L > seqlen else 0
        crop = ids[i:i + seqlen]
        if len(crop) < seqlen:  # tiny corpus: reference assumes L > seqlen
            crop = np.pad(crop, (0, seqlen - len(crop)), mode="wrap")
        out[s] = crop
    return out


def _seeded_doc_crops(docs, tokenizer, nsamples: int, seqlen: int,
                      seed: int) -> np.ndarray:
    """The c4 per-document protocol (data_gptq.py get_c4:88-104): draw a
    random document until one tokenizes to >= seqlen, then a random crop
    within it -- same stdlib rng sequence as the reference (one randint
    per rejected document, one per accepted, one per crop)."""
    import random
    random.seed(seed)
    out = np.empty((nsamples, seqlen), np.int32)
    for s in range(nsamples):
        guard = 0
        while True:
            i = random.randint(0, len(docs) - 1)
            ids = _encode(tokenizer, docs[i])
            if len(ids) >= seqlen:
                break
            guard += 1
            if guard > 10000:
                raise DatasetUnavailable(
                    f"no document tokenizes to >= {seqlen} tokens")
        i = random.randint(0, len(ids) - seqlen - 1) \
            if len(ids) > seqlen else 0
        out[s] = ids[i:i + seqlen]
    return out


def get_loaders(name: str, tokenizer, nsamples: int = 128, seed: int = 0,
                seqlen: int = 2048):
    """GPTQ-style seeded calibration loaders (reference data_gptq.py
    ``get_loaders``:178-193): returns ``(train [nsamples, seqlen] int32,
    test_ids flat int32 | None)``.

    Protocol per dataset family, matching the reference's sampling rng:
    - wikitext-2 / ptb(-new) / pile: concatenate the train corpus, tokenize
      once, draw seeded random seqlen crops (get_wikitext2:36-55);
    - c4(-new): per-document rejection sampling then an in-document crop
      (get_c4:79-104); the c4 test side uses seed 0 over validation docs
      (c4) or the first 1100 joined docs truncated to 256*seqlen (c4_new).

    Network-gated: raises :class:`DatasetUnavailable` offline. For offline
    plumbing use :func:`synthetic_loaders`.
    """
    train_splits = {"wikitext-2": "train", "ptb": "train", "c4": "train",
                    "ptb-new": "train", "c4-new": "train",
                    "pile": "validation"}
    base = name.replace("_", "-")
    task = {"ptb-new": "ptb", "c4-new": "c4"}.get(base, base)
    cfg = task_dataset_configs.get(task)
    if cfg is None:
        raise ValueError(f"unknown dataset {name!r}")
    from dataclasses import replace as _rep
    tcfg = _rep(cfg, split=train_splits.get(base, "train"))
    try:
        from datasets import load_dataset
        train = load_dataset(tcfg.path, tcfg.name, split=tcfg.split)
        test = load_dataset(cfg.path, cfg.name, split=cfg.split)
    except Exception as e:
        raise DatasetUnavailable(
            f"dataset {name!r} unavailable (offline?): {e}") from e
    if task == "c4":
        docs = [row[cfg.field] for row in train]
        crops = _seeded_doc_crops(docs, tokenizer, nsamples, seqlen, seed)
        vdocs = [row[cfg.field] for row in test]
        if base == "c4-new":
            vids = _encode(tokenizer, " ".join(vdocs[:1100]))
            test_ids = vids[:256 * seqlen]
        else:
            test_ids = _seeded_doc_crops(
                vdocs, tokenizer, 256, seqlen, seed=0).reshape(-1)
        return crops, test_ids
    tids = _encode(tokenizer, tcfg.join.join(r[tcfg.field] for r in train))
    crops = seeded_crops(tids, nsamples, seqlen, seed)
    test_ids = _encode(tokenizer, cfg.join.join(r[cfg.field] for r in test))
    return crops, test_ids


def synthetic_loaders(tokenizer_vocab: int, nsamples: int = 8,
                      seqlen: int = 256, seed: int = 0):
    """Offline stand-in for :func:`get_loaders` running the SAME seeded
    crop protocol over a synthetic corpus (deterministic: same seed, same
    crops)."""
    ids = synthetic_tokens(tokenizer_vocab, n_tokens=max(
        seqlen * 16, seqlen + 2), seed=seed)
    return seeded_crops(ids, nsamples, seqlen, seed), ids


def get_calibration_loader(task: str, tokenizer, nsamples: int = 128,
                           seqlen: int = 2048, seed: int = 0) -> np.ndarray:
    """Back-compat wrapper returning just the calibration crops from
    :func:`get_loaders`."""
    return get_loaders(task, tokenizer, nsamples=nsamples, seed=seed,
                       seqlen=seqlen)[0]
