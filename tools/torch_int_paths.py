#!/usr/bin/env python3
"""Run the W4A8 and W8A8 main paths and their serving phase of one checkout
on one NVIDIA GPU: ``chip_smoke.py``'s ``int_main_path`` and
``int_serving`` at full width and depth, with their checks and launch
counts.

    python3 tools/torch_int_paths.py [--root DIR] [--fmts w4a8,w8a8]
        [--layers N]

Prints ``chip_smoke.py``'s ``main_path_<fmt>`` and ``serving_<fmt>`` JSON
lines (the 64-token prompt's ``prefill_ms`` and decode figures at batch 1
and 4, a 1024-token forward, and the engine's ms per step, linear and
attention ms per step at 8 active slots), after a line naming the
checkout and the card's ``nvidia-smi`` name and power limit. ``--root
DIR`` imports ``any4_tpu_torch`` and ``chip_smoke.py`` from another
checkout (for example the parent commit unpacked with ``git archive``):
run both in one call to compare them on one card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--fmts", default="w4a8,w8a8")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_int_paths: no CUDA device", file=sys.stderr)
        sys.exit(1)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from any4_tpu_torch.models import generate as gen_mod, llama
    from any4_tpu_torch.ops import build, gemv, linear
    from any4_tpu_torch.quant import api
    from any4_tpu_torch.serving import engine as teng, kv_cache as kvc
    if not os.path.abspath(gemv.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {gemv.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.emit({"version": "this tree" if root == REPO else root,
             "nvidia_smi": smi})
    for fmt in args.fmts.split(","):
        _, qparams, cfg = cs.int_main_path(args, fmt, gemv, llama, gen_mod,
                                           api, linear)
        cs.int_serving(teng, gemv, kvc, linear, qparams, cfg, fmt,
                       cs.serve_prompts(cfg))
        del qparams
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
