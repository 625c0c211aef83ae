#!/usr/bin/env python3
"""Whether weights kept on the host slow ``chip_smoke.py``'s serving phase.

    python3 tools/torch_serving_host_weights.py

One process runs ``chip_smoke.main_path`` (the any4 Llama-3.2-1B at full
depth), then ``chip_smoke.serving_phase`` four times: with the model's
bf16 weights on the host (A, as ``chip_smoke.py`` keeps them for its
``cli_tools`` phase) and without them (B), in the order A B B A. Prints
each run's seconds on the host clock, then the card's name and power limit.
"""
import argparse
import gc
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from any4_tpu_torch.models import generate as gen_mod, llama  # noqa: E402
from any4_tpu_torch.ops import build, gemv, linear  # noqa: E402
from any4_tpu_torch.quant import api  # noqa: E402
from any4_tpu_torch.serving import engine as teng, kv_cache as kvc  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    _, params, qparams, cfg, _ = cs.main_path(
        argparse.Namespace(layers=None), gemv, llama, gen_mod, api, linear)
    seconds = []
    for case in "ABBA":
        if case == "B":
            params = None
        elif params is None:
            params = cs.to_device(llama.init_params(cfg, seed=0,
                                                    device="cuda"),
                                  "cpu", linear)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cs.serving_phase(qparams, cfg, gemv, kvc, teng, llama, gen_mod,
                         linear)
        seconds.append((case, time.perf_counter() - t0))
    cs.emit({"phase": "serving_host_weights", "seconds": seconds})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
