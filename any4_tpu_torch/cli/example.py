"""Minimal before/after-any4 example (counterpart of ``example.py``): greedy
tokens of a model and of its any4 version, and their sizes.

  python -m any4_tpu_torch.cli.example [--model-dir DIR] [--cpu]

A random tiny model by default; ``--model-dir`` takes a local HF
checkpoint.
"""
from __future__ import annotations

import argparse

from ..models import generate
from ..quant import api
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_model_args(p)
    p.add_argument("--prompt-tokens", type=int, default=8)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.device(args)
    cfg, params = common.model(args, dev, vocab=1024)

    prompt = common.random_ids((1, args.prompt_tokens), cfg.vocab_size, dev)
    before = generate.generate(params, cfg, prompt, max_new_tokens=8,
                               device=dev)
    print("before any4:", before[0].tolist())
    qparams = api.quant_methods["any4"](params, group_size=128,
                                        kmeans_iters=10, device=dev)
    after = generate.generate(qparams, cfg, prompt, max_new_tokens=8,
                              device=dev)
    print("after any4: ", after[0].tolist())
    print(f"model size: {api.model_size_bytes(params)/1e6:.1f} MB -> "
          f"{api.model_size_bytes(qparams)/1e6:.1f} MB")
    return before, after


if __name__ == "__main__":
    main()
