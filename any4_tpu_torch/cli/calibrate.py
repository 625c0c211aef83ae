"""Offline calibration (counterpart of ``cli_calibrate.py``): forward passes
that save each linear's mean |input| for any4's weighted k-means, as an
``.npz`` that both packages read.

  python -m any4_tpu_torch.cli.calibrate --model-dir /path/to/model \\
      --output acts.npz
  python -m any4_tpu_torch.cli.calibrate --tiny --output /tmp/acts.npz

``--dataset`` calibrates on ``--num-samples`` rows of ``--max-seq-len``
tokens of a dataset task (``evals.datasets.load_tokens``), encoded by the
checkpoint's tokenizer, or byte by byte (``tasks_local.ByteTokenizer``)
for the tiny model; without network access it raises
``DatasetUnavailable``.
"""
from __future__ import annotations

import argparse

import torch

from .. import calibrate as cal
from ..evals import datasets, tasks_local
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_model_args(p)
    p.add_argument("--prompt", default=None,
                   help="calibration text (default: built-in multi-domain "
                        "prompt)")
    p.add_argument("--dataset", default=None,
                   help="dataset task name (evals.datasets)")
    p.add_argument("--num-samples", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--output", required=True, help=".npz output path")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.device(args)
    cfg, params = common.model(args, dev, vocab=2048)
    tiny = args.tiny or not args.model_dir
    tok = None if tiny else common.tokenizer(args.model_dir)
    if not tiny and tok is None:
        raise RuntimeError(f"no tokenizer in {args.model_dir}")
    if args.dataset:
        seq = args.max_seq_len
        tokens = datasets.load_tokens(
            args.dataset, tok or tasks_local.ByteTokenizer(),
            max_tokens=args.num_samples * seq)
        ids = torch.from_numpy(
            tokens[:len(tokens) // seq * seq].reshape(-1, seq)
            [:args.num_samples]).to(dev)
    elif tiny:
        ids = common.random_ids((2, 64), cfg.vocab_size, dev)
    else:
        text = args.prompt or cal.default_prompt
        ids = torch.tensor([tok(text)["input_ids"]], dtype=torch.int32,
                           device=dev)

    acts = cal.calibrate(params, cfg, ids, device=dev)
    cal.save_calibration(acts, args.output)
    print(f"saved {len(acts)} layer activations to {args.output}")
    return acts


if __name__ == "__main__":
    main()
