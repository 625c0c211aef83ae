"""Layer microbenchmark (counterpart of ``cli_microbenchmark.py``): one
quantized linear against the bf16 matmul on the same weight.

  python -m any4_tpu_torch.cli.microbenchmark --input-dim 4096 \\
      --output-dim 4096 --quantize any4 --batch 1
  python -m any4_tpu_torch.cli.microbenchmark --sweep

Each call is timed by :func:`any4_tpu_torch.utils.best_in_ms` (on the card:
CUDA events, the L2 emptied before each call, the best of ``--rounds``
windows of ``--iters`` calls, the two sides interleaved). The single-format
mode times the production dispatch ``linear.linear(x, qt)`` and prints the
kernels it launched (``gemv.LAUNCHES``); ``--sweep`` times
``gemv.quantized_matmul`` on each format's kernel name at K = N from 1024
to 8192: int4 runs kernel C, nf4 and any4 kernel A.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops import gemv
from ..ops import linear as lin
from ..utils import best_in_ms
from . import common

FORMATS = ["int4", "int4p", "int8", "int8p", "w4a8", "w8a8", "any4", "nf4",
           "fp4", "mx4"]
SWEEP_KS = (1024, 2048, 3072, 4096, 5120, 6144, 7168, 8192)
SWEEP_FORMATS = ("int4", "nf4", "any4")


def _operands(n: int, k: int, m: int, dev: str):
    """The weight ``[n, k]`` f32 (seed 0) and ``x [m, k]`` bf16 (seed 1)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((n, k), generator=gen, device=dev, dtype=torch.float32)
    gen.manual_seed(1)
    x = torch.randn((m, k), generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    return w, x


def main(argv=None, check: Optional[Callable] = None):
    """The single-format row (or ``--sweep``'s table). ``check(x, qt)``,
    when given, is called on the row's operands before they are timed; its
    launches are not counted in ``kernels``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input-dim", type=int, default=4096)
    p.add_argument("--output-dim", type=int, default=4096)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--quantize", default="any4", choices=FORMATS)
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--rounds", type=int, default=12)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--sweep", action="store_true",
                   help="the reference's 1xK . KxK table: K = N = "
                        "1024..8192, speedups of int4, nf4 and any4")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.device(args)
    if args.sweep:
        return sweep(m=args.batch, group_size=args.group_size,
                     rounds=args.rounds, iters=args.iters, device=dev)

    k, n, m = args.input_dim, args.output_dim, args.batch
    g = 32 if args.quantize == "mx4" else args.group_size
    w, x = _operands(n, k, m, dev)
    wb = w.to(torch.bfloat16)
    kw = dict(kmeans_iters=8) if args.quantize == "any4" else {}
    qt = lin.quantize_tensor(w, args.quantize, g, **kw)
    if check is not None:
        check(x, qt)
    before = dict(gemv.LAUNCHES)
    ms = best_in_ms({"bf16": lambda: x @ wb.T,
                     "quant": lambda: lin.linear(x, qt)},
                    iters=args.iters, rounds=args.rounds)
    kernels = {name: c - before[name] for name, c in gemv.LAUNCHES.items()
               if c != before[name]}
    tb, tq = ms["bf16"] / 1e3, ms["quant"] / 1e3
    out = {
        "fmt": args.quantize, "m": m, "k": k, "n": n,
        "bf16_us": tb * 1e6, "quant_us": tq * 1e6, "speedup": tb / tq,
        "weight_bytes": qt.nbytes, "weight_gbps": qt.nbytes / tq / 1e9,
        "weight_fmt": qt.fmt, "kernels": kernels,
        "route": ("hand-written kernels" if kernels else
                  "no hand-written kernel" + (" (CPU: plain versions)"
                                              if dev == "cpu" else "")),
        "device": common.device_name(dev),
    }
    print(json.dumps(out))
    return out


def sweep_operands(k: int, m: int = 1, group_size: int = 128,
                   device="cuda", kmeans_iters: int = 4):
    """One row of the sweep at K = N = ``k``: ``x [m, k]`` bf16, the bf16
    weight and ``{fmt: QuantizedTensor}`` for int4, nf4 and any4."""
    w, x = _operands(k, k, m, device)
    qts = {fmt: lin.quantize_tensor(
        w, fmt, group_size,
        **(dict(kmeans_iters=kmeans_iters) if fmt == "any4" else {}))
        for fmt in SWEEP_FORMATS}
    return x, w.to(torch.bfloat16), qts


def sweep_call(x: torch.Tensor, qt: lin.QuantizedTensor) -> torch.Tensor:
    """``gemv.quantized_matmul`` on ``qt``'s kernel format name."""
    return gemv.quantized_matmul(x, qt.packed, qt.scales, qt.zeros, qt.lut,
                                 group_size=qt.group_size,
                                 fmt=lin._kernel_fmt(qt.fmt, qt.lut))


def sweep(ks: Sequence[int] = SWEEP_KS, m: int = 1, group_size: int = 128,
          rounds: int = 12, iters: int = 20, device="cuda",
          kmeans_iters: int = 4,
          check: Optional[Callable] = None) -> Dict[int, Dict]:
    """The 1xK . KxK table: for each K, bf16, int4, nf4 and any4 timed in
    interleaved rounds (the best window of each), and per format the
    speedup over bf16 and its time (``{fmt}_us``). ``check(k, x, wb,
    qts)``, when given, is called on each row's operands before it is
    timed."""
    table = {}
    for k in ks:
        x, wb, qts = sweep_operands(k, m, group_size, device, kmeans_iters)
        if check is not None:
            check(k, x, wb, qts)
        fns = {"bf16": lambda: x @ wb.T}
        fns.update({fmt: (lambda qt=qt: sweep_call(x, qt))
                    for fmt, qt in qts.items()})
        best = best_in_ms(fns, iters=iters, rounds=rounds)
        row = {fmt: best["bf16"] / best[fmt] for fmt in SWEEP_FORMATS}
        row["bf16_us"] = best["bf16"] * 1e3
        row.update({f"{fmt}_us": best[fmt] * 1e3 for fmt in SWEEP_FORMATS})
        table[k] = row
        print(f"K={k}: {row}", file=sys.stderr)
    print(json.dumps({**table, "device": common.device_name(device)}))
    return table


if __name__ == "__main__":
    main()
