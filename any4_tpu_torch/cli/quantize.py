"""Offline model quantization (counterpart of ``cli_quantize.py``): an HF
checkpoint, or a random tiny model, to a quantized checkpoint in the format
both packages read (:mod:`any4_tpu_torch.models.checkpoint`), optionally
after an AWQ scale search and activation calibration.

  python -m any4_tpu_torch.cli.quantize --model-dir /path/Llama-3.2-1B \\
      --fmt any4 --calibrate --output /path/llama-any4
  python -m any4_tpu_torch.cli.quantize --tiny --fmt int4 --output /tmp/q

The calibration and AWQ tokens are the checkpoint tokenizer's encoding of
the built-in calibration prompt, or 128 seeded random ids without one.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import calibrate as cal
from ..models import checkpoint
from ..quant import api, awq
from . import common

FORMATS = ["int4", "int4p", "int8", "int8p", "w4a8", "w8a8", "any4", "any4t",
           "any4q8", "nf4", "fp4", "mx4"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_model_args(p)
    p.add_argument("--fmt", default="any4", choices=FORMATS)
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--kmeans-iters", type=int, default=30)
    p.add_argument("--calibrate", action="store_true")
    p.add_argument("--scale-sample-weight", action="store_true")
    p.add_argument("--awq", action="store_true",
                   help="run AWQ scale search before quantizing")
    p.add_argument("--dump-awq", default=None,
                   help="save the AWQ search artifact (.npz) for reuse "
                        "(reference --dump_awq)")
    p.add_argument("--load-awq", default=None,
                   help="apply a saved AWQ artifact instead of searching "
                        "(reference --load_awq)")
    p.add_argument("--quantize-args", default="",
                   help="extra k=v args for the quantizer (e.g. "
                        "int_zeros=True for rounded-integer zero points, "
                        "scale_only=True for symmetric)")
    p.add_argument("--row-parallel-shards", type=int, default=1,
                   help="pack k as N shards for row-parallel TP (not "
                        "ported: only 1)")
    p.add_argument("--output", required=True)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.device(args)

    # the native host-side data plane (int4 packing in C++) is not ported
    print("native data plane: off")
    cfg, params = common.model(args, dev, vocab=1024)
    tok = common.tokenizer(None if args.tiny else args.model_dir)
    if tok is not None:
        ids = torch.tensor([tok(cal.default_prompt)["input_ids"]],
                           dtype=torch.int32, device=dev)
    else:
        ids = common.random_ids((1, 128), cfg.vocab_size, dev)

    if args.load_awq:
        t0 = time.time()
        params = awq.apply_awq(params, awq.load_awq(args.load_awq),
                               device=dev)
        print(f"awq artifact applied in {time.time() - t0:.1f}s")
    elif args.awq:
        t0 = time.time()
        awq_results, params = awq.run_awq(params, cfg, ids,
                                          group_size=args.group_size,
                                          progress=True, device=dev)
        print(f"awq done in {time.time() - t0:.1f}s")
        if args.dump_awq:
            awq.save_awq(args.dump_awq, awq_results)
            print(f"awq artifact saved to {args.dump_awq}")

    sample_weight = None
    if args.calibrate and args.fmt == "any4":
        t0 = time.time()
        sample_weight = cal.calibrate(params, cfg, ids, device=dev)
        print(f"calibration done in {time.time() - t0:.1f}s")

    kw = common.parse_kv_args(args.quantize_args)
    if args.fmt == "any4":
        kw.update(kmeans_iters=args.kmeans_iters,
                  scale_sample_weight=args.scale_sample_weight)
    t0 = time.time()
    qparams = api.quantize_model(
        params, fmt=args.fmt, group_size=args.group_size,
        sample_weight=sample_weight, progress=True,
        row_parallel_shards=args.row_parallel_shards, device=dev, **kw)
    print(f"quantized in {time.time() - t0:.1f}s; "
          f"{api.model_size_bytes(params) / 1e6:.1f} MB -> "
          f"{api.model_size_bytes(qparams) / 1e6:.1f} MB")
    checkpoint.save_params(args.output, qparams, cfg)
    print(f"saved to {args.output}")
    return qparams, cfg


if __name__ == "__main__":
    main()
