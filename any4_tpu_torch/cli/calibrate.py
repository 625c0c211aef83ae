"""Offline calibration (counterpart of ``cli_calibrate.py``): forward passes
that save each linear's mean |input| for any4's weighted k-means, as an
``.npz`` that both packages read.

  python -m any4_tpu_torch.cli.calibrate --model-dir /path/to/model \\
      --output acts.npz
  python -m any4_tpu_torch.cli.calibrate --tiny --output /tmp/acts.npz
"""
from __future__ import annotations

import argparse

import torch

from .. import calibrate as cal
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_model_args(p)
    p.add_argument("--prompt", default=None,
                   help="calibration text (default: built-in multi-domain "
                        "prompt)")
    p.add_argument("--dataset", default=None,
                   help="dataset task name (not ported yet)")
    p.add_argument("--num-samples", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--output", required=True, help=".npz output path")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    if args.dataset:
        raise NotImplementedError(
            "--dataset needs the port of evals/datasets.py (ROADMAP queue "
            "1, item 11c)")
    dev = common.device(args)
    cfg, params = common.model(args, dev, vocab=2048)
    if args.tiny or not args.model_dir:
        ids = common.random_ids((2, 64), cfg.vocab_size, dev)
    else:
        tok = common.tokenizer(args.model_dir)
        if tok is None:
            raise RuntimeError(f"no tokenizer in {args.model_dir}")
        text = args.prompt or cal.default_prompt
        ids = torch.tensor([tok(text)["input_ids"]], dtype=torch.int32,
                           device=dev)

    acts = cal.calibrate(params, cfg, ids, device=dev)
    cal.save_calibration(acts, args.output)
    print(f"saved {len(acts)} layer activations to {args.output}")
    return acts


if __name__ == "__main__":
    main()
