"""Evaluation harness: task routing + incremental result logging
(counterpart of ``any4_tpu/evals/harness.py``).

The reference's eval.py:86-321 ``main`` routes between GPTQ-style
perplexity, streaming perplexity, BigCode and lm-eval tasks, logging each
task's result incrementally into ``results.json`` (eval.py:37-59
``log_results``) and recording ``args.json`` + ``command_line.txt`` for
replay (eval.py:114-123). This module is the framework-side equivalent;
the CLI lives in :mod:`any4_tpu_torch.cli.eval`. The files it writes
(``results.json``, ``args.json``, ``command_line.txt``) have the JAX
package's layout, so the repo's ``cli_process_logs.py`` reads them.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np


def log_args(log_dir: str, args: Dict):
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "args.json"), "w") as f:
        json.dump(args, f, indent=2, default=str)
    with open(os.path.join(log_dir, "command_line.txt"), "w") as f:
        f.write("python " + " ".join(sys.argv) + "\n")


def log_results(log_dir: str, task: str, result, extra: Optional[Dict] = None):
    """Append/update one task's result in <log_dir>/results.json."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "results.json")
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            try:
                data = json.load(f)
            except json.JSONDecodeError:
                data = {}
    entry = {"result": result, "time": time.time()}
    if extra:
        entry.update(extra)
    data[task] = entry
    with open(path, "w") as f:
        json.dump(data, f, indent=2, default=str)
    return data


def task_done(log_dir: str, task: str) -> bool:
    """True if results.json already holds this task (the
    ``--overwrite-results=False`` skip logic, eval.py:150-161)."""
    path = os.path.join(log_dir, "results.json")
    if not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            return task in json.load(f)
    except json.JSONDecodeError:
        return False


def run_perplexity_tasks(params, cfg, tasks, tokenizer=None, seqlen=2048,
                         log_dir=None, overwrite=False, max_chunks=None,
                         synthetic=False, progress=False,
                         evaluator="chunked",
                         device="cuda") -> Dict[str, float]:
    """Evaluate perplexity on each named task; returns {task: ppl}.

    ``evaluator``: "chunked" = GPTQ-style fixed-seqlen NLL over the
    concatenated corpus (reference data_gptq.py:195-220); "stream" =
    per-document token-weighted NLL (reference data.py:37-130). With
    ``synthetic=True`` (or when a dataset is unavailable offline) a
    deterministic synthetic stream is used and the task is logged as
    ``synthetic:<task>``. ``params`` must live on ``device``."""
    from . import datasets, perplexity

    out = {}
    for task in tasks:
        name = task
        if log_dir and not overwrite and task_done(log_dir, name):
            if progress:
                print(f"skip {name} (already in results.json)")
            continue
        try:
            if synthetic:
                raise datasets.DatasetUnavailable("synthetic requested")
            tokens = datasets.load_tokens(task, tokenizer)
        except datasets.DatasetUnavailable:
            name = f"synthetic:{task}"
            tokens = datasets.synthetic_tokens(cfg.vocab_size)
            # re-check the skip under the fallback task name
            if log_dir and not overwrite and task_done(log_dir, name):
                if progress:
                    print(f"skip {name} (already in results.json)")
                continue
        if evaluator == "stream":
            # split the flat stream into pseudo-documents for the
            # streaming evaluator when real documents are unavailable
            docs = np.array_split(tokens, max(len(tokens) // (4 * seqlen),
                                              1))
            ppl = perplexity.eval_perplexity_stream(
                params, cfg, docs, seqlen=seqlen, device=device)
        else:
            ppl = perplexity.eval_perplexity_chunked(
                params, cfg, tokens, seqlen=seqlen, max_chunks=max_chunks,
                progress=progress, device=device)
        out[name] = ppl
        if progress:
            print(f"{name}: ppl {ppl:.4f}")
        if log_dir:
            log_results(log_dir, name, ppl, {"seqlen": seqlen})
    return out
