"""Evaluation (counterpart of ``cli_eval.py``, the reference eval.py
equivalent): perplexity, the LM protocol's tasks and code eval of a model,
quantized or not, logged into ``--log-dir``.

  # perplexity of an any4-quantized local HF checkpoint
  python -m any4_tpu_torch.cli.eval --model-dir /path/to/Llama-3.2-1B \\
      --quantize any4 --quantize-args group_size=128,scale_sample_weight=True \\
      --tasks wikitext-2,c4 --log-dir logs/any4

  # offline plumbing check with a random-init tiny model + synthetic data
  python -m any4_tpu_torch.cli.eval --cpu --tiny --quantize int4 \\
      --tasks synthetic --seqlen 128 --max-chunks 2 --log-dir logs/t

``--calibrate`` without a tokenizer calibrates on 128 token ids drawn by
``common.random_ids`` (a ``torch.Generator`` seeded with 1), where the JAX
script draws them with ``jax.random``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import calibrate as cal
from ..evals import code_eval, harness, lm_eval_adapter, tasks_local
from ..models import checkpoint
from ..quant import api
from . import common

QUANTIZE = [None, "int4", "int4p", "int8", "int8p", "w4a8", "w8a8", "any4",
            "any4t", "any4q8", "nf4", "fp4", "mx4", "intq", "anyq"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_model_args(p)
    p.add_argument("--load-quantized", help="load a saved quantized checkpoint")
    p.add_argument("--save-quantized", help="save quantized params to dir")
    p.add_argument("--quantize", default=None, choices=QUANTIZE)
    p.add_argument("--quantize-args", default="",
                   help="k=v,... forwarded to the quantizer")
    p.add_argument("--pseudo", action="store_true",
                   help="fake-quantize (dense reconstruction)")
    p.add_argument("--calibrate", action="store_true",
                   help="calibrate sample weights on the default prompt")
    p.add_argument("--tasks", default="wikitext-2",
                   help="comma-separated perplexity tasks, or 'synthetic'")
    p.add_argument("--evaluator", default="chunked",
                   choices=["chunked", "stream"],
                   help="chunked = GPTQ-style fixed-seqlen NLL (reference "
                        "data_gptq.llama_eval); stream = per-document "
                        "token-weighted NLL (reference data.eval_perplexity)")
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--max-chunks", type=int, default=None)
    p.add_argument("--log-dir", default="logs/eval")
    p.add_argument("--overwrite-results", action="store_true")
    p.add_argument("--tokenizer-dir", default=None)
    p.add_argument("--lm-eval-tasks", default=None,
                   help="comma-separated lm-evaluation-harness tasks; "
                        "'local_mc' runs the builtin offline task through "
                        "the same LM protocol (no lm_eval install needed)")
    p.add_argument("--lm-eval-limit", type=int, default=None)
    p.add_argument("--code-tasks", default=None,
                   help="comma-separated BigCode-style code tasks "
                        "(builtin, humaneval): generate -> execute -> "
                        "pass@k")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.device(args)

    harness.log_args(args.log_dir, vars(args))

    tokenizer = None
    if args.load_quantized:
        params, cfg = checkpoint.load_params(args.load_quantized, device=dev)
    else:
        cfg, params = common.model(args, dev, vocab=2048)
        if not args.tiny and args.model_dir:
            tokenizer = common.tokenizer(args.tokenizer_dir or args.model_dir)
            if tokenizer is None:
                print("tokenizer unavailable; synthetic data only",
                      file=sys.stderr)

    if args.quantize and not args.load_quantized:
        qargs = common.parse_kv_args(args.quantize_args)
        sample_weight = None
        if args.calibrate:
            if tokenizer is not None:
                ids = torch.tensor([tokenizer(cal.default_prompt)["input_ids"]],
                                   dtype=torch.int32, device=dev)
            else:
                ids = common.random_ids((1, 128), cfg.vocab_size, dev)
            sample_weight = cal.calibrate(params, cfg, ids, device=dev)
        params = api.quant_methods[args.quantize](
            params, pseudo=args.pseudo, sample_weight=sample_weight,
            progress=True, device=dev, **qargs)
        if args.save_quantized:
            checkpoint.save_params(args.save_quantized, params, cfg)

    tasks = [t.strip() for t in args.tasks.split(",") if t.strip()]
    synthetic = tasks == ["synthetic"]
    if synthetic:
        tasks = ["wikitext-2"]
    results = harness.run_perplexity_tasks(
        params, cfg, tasks, tokenizer=tokenizer, seqlen=args.seqlen,
        log_dir=args.log_dir, overwrite=args.overwrite_results,
        max_chunks=args.max_chunks, synthetic=synthetic, progress=True,
        evaluator=args.evaluator, device=dev)

    lm = None
    if args.lm_eval_tasks or args.code_tasks:
        tok = tokenizer or tasks_local.ByteTokenizer()
        lm = lm_eval_adapter.TorchCausalLM(params, cfg, tok,
                                           max_length=args.seqlen, device=dev)

    if args.lm_eval_tasks:
        lm_tasks = [t.strip() for t in args.lm_eval_tasks.split(",")]
        local = [t for t in lm_tasks if t.startswith("local")]
        remote = [t for t in lm_tasks if not t.startswith("local")]
        for t in local:
            r = tasks_local.run_local_task(lm, t)
            results[f"lm-eval:{t}"] = r
            harness.log_results(args.log_dir, f"lm-eval:{t}", r)
        if remote:
            try:
                lm_res = lm_eval_adapter.simple_evaluate(
                    params, cfg, tokenizer, remote,
                    limit=args.lm_eval_limit, max_length=args.seqlen,
                    device=dev)
                for t, r in lm_res.get("results", {}).items():
                    results[f"lm-eval:{t}"] = r
                    harness.log_results(args.log_dir, f"lm-eval:{t}", r)
            except lm_eval_adapter.LmEvalUnavailable as e:
                print(f"lm-eval skipped: {e}", file=sys.stderr)

    if args.code_tasks:
        code_tasks = [t.strip() for t in args.code_tasks.split(",")]
        code_res = code_eval.run_code_tasks(
            lm, code_tasks, log_dir=args.log_dir, progress=True)
        for t, r in code_res.items():
            results[f"code:{t}"] = r
            harness.log_results(args.log_dir, f"code:{t}", r)

    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
