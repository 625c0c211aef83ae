"""Model diff (counterpart of ``cli_diff.py``, the reference diff.py
equivalent): per-layer activation MSE + cosine similarity between a
baseline model and its pseudo-quantized version on one prompt, written to
diffs.csv.

  python -m any4_tpu_torch.cli.diff --cpu --tiny --quantize any4 \\
      --log-dir /tmp/diff

The prompt is ``--prompt-tokens`` ids drawn by ``common.random_ids`` (a
``torch.Generator`` seeded with 1), where the JAX script draws them with
``jax.random``.
"""
from __future__ import annotations

import argparse

from ..evals import analyze, harness
from ..quant import api
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_model_args(p)
    p.add_argument("--quantize", default="any4")
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--pseudo", action="store_true", default=True,
                   help="accepted and ignored, so that cli_diff.py's "
                        "command lines parse: the quantized copy is always "
                        "its dense reconstruction")
    p.add_argument("--log-dir", default="logs/diff")
    p.add_argument("--prompt-tokens", type=int, default=64)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.device(args)

    harness.log_args(args.log_dir, vars(args))
    cfg, params = common.model(args, dev, vocab=512)
    ids = common.random_ids((1, args.prompt_tokens), cfg.vocab_size, dev)
    kw = dict(kmeans_iters=10) if args.quantize in ("any4", "anyq") else {}
    qparams = api.quant_methods[args.quantize](
        params, group_size=args.group_size, pseudo=True, device=dev, **kw)
    rows = analyze.diff_models(params, qparams, cfg, ids,
                               out_dir=args.log_dir)
    for r in rows:
        print(f"{r['layer']}: mse {r['mse']:.3e} cossim {r['cossim']:.5f}")
    return rows


if __name__ == "__main__":
    main()
