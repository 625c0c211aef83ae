"""Model benchmark (counterpart of ``cli_benchmark.py``): decode throughput
of a model and of its quantized version, with an optional per-layer
attention/MLP split (:mod:`any4_tpu_torch.profiler`).

  python -m any4_tpu_torch.cli.benchmark --tiny --quantize any4 \\
      --max-new-tokens 64
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..models import generate, llama
from ..profiler import profile_decode_components
from ..quant import api
from . import common


def decode_tokens_per_s(params, cfg, prompt, new_tokens, trials=3):
    """Decode tokens per second of ``generate.decode_loop`` after a prefill
    of ``prompt [b, t]``: one warm-up loop, then the best of ``trials``
    host-clock runs of ``new_tokens`` steps, each ending in a read of the
    last token. Returns ``(tokens_per_s, tokens)``: ``tokens [b,
    new_tokens + 1]`` are the prefill's greedy token and the timed loop's,
    so their first ``new_tokens`` equal ``generate``'s at
    ``max_new_tokens=new_tokens``."""
    b, t = prompt.shape
    caches = llama.init_kv_caches(cfg, b, t + new_tokens,
                                  device=prompt.device)
    logits, caches = generate.prefill(params, cfg, prompt.long(), caches)
    tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    toks, *_ = generate.decode_loop(params, cfg, tok, t, caches, new_tokens)
    int(toks[0, -1])
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        toks, *_ = generate.decode_loop(params, cfg, tok, t, caches,
                                        new_tokens)
        int(toks[0, -1])            # waits for the device
        best = min(best, time.perf_counter() - t0)
    return new_tokens * b / best, torch.cat([tok[:, None], toks], dim=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_model_args(p)
    p.add_argument("--quantize", default="any4",
                   choices=sorted(api.quant_methods))
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--prompt-tokens", type=int, default=32)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--profile", action="store_true",
                   help="per-layer attention vs MLP timing breakdown")
    p.add_argument("--profile-ctx", type=int, default=256)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.device(args)
    cfg, params = common.model(args, dev, vocab=2048)

    prompt = common.random_ids((args.batch, args.prompt_tokens),
                               cfg.vocab_size, dev)
    tps_base, _ = decode_tokens_per_s(params, cfg, prompt,
                                      args.max_new_tokens)
    print(f"baseline: {tps_base:.1f} tok/s", file=sys.stderr)

    kw = dict(kmeans_iters=10) if args.quantize in ("any4", "anyq") else {}
    qparams = api.quant_methods[args.quantize](
        params, group_size=args.group_size, device=dev, **kw)
    tps_q, _ = decode_tokens_per_s(qparams, cfg, prompt, args.max_new_tokens)
    print(f"{args.quantize}: {tps_q:.1f} tok/s", file=sys.stderr)

    out = {
        "baseline_tok_s": tps_base,
        f"{args.quantize}_tok_s": tps_q,
        "speedup": tps_q / tps_base,
        "model_bytes_baseline": api.model_size_bytes(params),
        "model_bytes_quantized": api.model_size_bytes(qparams),
    }
    if args.profile:
        out["profile_baseline"] = profile_decode_components(
            params, cfg, batch=args.batch, ctx=args.profile_ctx)
        out["profile_quantized"] = profile_decode_components(
            qparams, cfg, batch=args.batch, ctx=args.profile_ctx)
    out["device"] = common.device_name(dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
