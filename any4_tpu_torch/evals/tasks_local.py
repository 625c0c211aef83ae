"""Offline-executable task definitions for the LM protocol (a copy of
``any4_tpu/evals/tasks_local.py``, which uses no JAX).

The reference validates its lm-eval route end-to-end with real tasks
(test_eval.py: piqa accuracy over 50 samples). Without network access and
without lm_eval installed, this module provides the same execution shape
locally: a byte-level tokenizer, a multiple-choice runner that drives
``loglikelihood`` exactly like lm-eval's multiple_choice tasks, and a small
builtin task -- so the whole request/batching/scoring pipeline executes
and is tested without the harness installed.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class ByteTokenizer:
    """UTF-8 byte tokenizer (ids 0..255) for offline protocol tests."""

    vocab_size = 256
    bos_token_id = 1
    eos_token_id = 0

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8",
                                                       errors="replace")

    def __call__(self, text: str) -> Dict:
        return {"input_ids": self.encode(text)}


# A tiny multiple-choice task in lm-eval's (context, choices, gold) shape.
BUILTIN_MC_EXAMPLES = [
    {"context": "The sky on a clear day is",
     "choices": [" blue", " loud", " wooden"], "gold": 0},
    {"context": "Two plus two equals",
     "choices": [" four", " fish", " never"], "gold": 0},
    {"context": "Water freezes into",
     "choices": [" ice", " smoke", " sand"], "gold": 0},
    {"context": "A dog is a kind of",
     "choices": [" animal", " mineral", " vehicle"], "gold": 0},
    {"context": "The opposite of hot is",
     "choices": [" cold", " tall", " green"], "gold": 0},
    {"context": "Books are made to be",
     "choices": [" read", " eaten", " planted"], "gold": 0},
]


def run_multiple_choice(lm, examples: List[Dict]) -> Dict[str, float]:
    """Score each (context, choice) pair with ``lm.loglikelihood`` and pick
    the argmax choice -- the execution shape of lm-eval multiple_choice
    tasks. Returns ``acc`` and length-normalized ``acc_norm``."""
    requests = []
    spans = []
    for ex in examples:
        start = len(requests)
        for choice in ex["choices"]:
            requests.append((ex["context"], choice))
        spans.append((start, len(requests), ex["gold"]))
    scores = lm.loglikelihood(requests)
    n_acc = n_norm = 0
    for (start, end, gold), ex in zip(spans, examples):
        lls = np.array([scores[i][0] for i in range(start, end)])
        lens = np.array([max(len(c), 1) for c in ex["choices"]])
        if int(np.argmax(lls)) == gold:
            n_acc += 1
        if int(np.argmax(lls / lens)) == gold:
            n_norm += 1
    n = len(examples)
    return {"acc": n_acc / n, "acc_norm": n_norm / n, "n": n}


def run_local_task(lm, task: str) -> Dict[str, float]:
    if task in ("local_mc", "builtin_mc"):
        return run_multiple_choice(lm, BUILTIN_MC_EXAMPLES)
    raise KeyError(f"unknown local task {task!r} (have: local_mc)")
