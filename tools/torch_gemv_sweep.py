#!/usr/bin/env python3
"""Time the port's kernel A (``q4_lut_post``, any4 at g=128) on one NVIDIA
GPU at the 1B linear shapes across m, each held against its plain version.

    python3 tools/torch_gemv_sweep.py [--root DIR] [--ms 1,8,16,128,512]
        [--shapes 2048x2048,512x2048,8192x2048,2048x8192] [--reps 20]
        [--out FILE]

For each (n, k) shape and m it checks the kernel's bf16 output against the
plain version within 1e-2 * max (``chip_smoke.py``'s bar) and prints one
JSON row with the kernel's median time (CUDA events over ``--reps``
launches; ``ms`` with the L2 emptied by reading a 128 MB buffer before each
launch, ``ms_dirty_l2`` by writing it), one bf16 ``torch.matmul`` on the
dequantized weight (``library_ms``, the same two ways; the port never calls
it) and the least time the card could take (``bound_ms``: bytes over the
memory rate or 2mnk over the bf16 tensor-core rate, the larger). A last
``layer`` row per m sums one Llama-3.2-1B decoder layer's 7 linears.

``--root DIR`` imports ``any4_tpu_torch`` and ``chip_smoke.py`` from another
checkout (for example the parent commit unpacked with ``git archive``) and
times its kernel A: the way to compare two versions within one call on one
card, run in turns (parent, this tree, this tree, parent). Rows also go to
``--out`` (JSON lines).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SHAPES = "2048x2048,512x2048,8192x2048,2048x8192"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--ms", default="1,8,16,128,512")
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_gemv_sweep: no CUDA device", file=sys.stderr)
        sys.exit(1)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import chip_smoke as cs
    from torch_attention_sweep import timers
    from any4_tpu_torch.ops import build, gemv, linear, packing
    if os.path.dirname(os.path.abspath(gemv.__file__)) != os.path.join(
            root, "any4_tpu_torch", "ops"):
        raise RuntimeError(f"imported {gemv.__file__}, not from {root}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    bw, peak = cs.peaks(torch.cuda.get_device_name(0))[1]
    version = "this tree" if root == REPO else root
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row = {"nvidia_smi": smi, "version": version, **row}
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()

    build.compile_source("q4_lut_gemv.cu", verbose=True)
    dirty, clean = timers(cs)
    ms_list = [int(m) for m in args.ms.split(",")]
    layer = {m: {} for m in ms_list}
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = 128
    for shape in args.shapes.split(","):
        n, k = (int(v) for v in shape.split("x"))
        codes = torch.randint(0, 16, (n, k), generator=gen, device="cuda",
                              dtype=torch.uint8)
        lut = torch.sort(torch.rand((n, 16), generator=gen, device="cuda"),
                         dim=1).values * 15.0 - 8.0
        G = packing.padded_k(k) // g
        scales = torch.rand((G, n), generator=gen, device="cuda") * 0.01 \
            + 1e-3
        zeros = torch.randn((G, n), generator=gen, device="cuda") * 0.01
        qt = linear.QuantizedTensor(packing.pack_codes(codes), scales, zeros,
                                    lut.contiguous(), "any4", g, (n, k))
        w_bf16 = linear.dequantize_tensor(qt, torch.bfloat16)
        fargs = (qt.packed, qt.scales, qt.zeros, qt.lut, g, torch.bfloat16)
        for m in ms_list:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            y = gemv.q4_lut_post(x, *fargs)
            ref = gemv.q4_lut_post_plain(x, *fargs)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            ok = bool(torch.isfinite(y).all()) and err <= 1e-2 * scale
            nbytes = (qt.packed.numel() * 4 + 2 * G * n * 4 + n * 16 * 4
                      + m * k * 2 + m * n * 2)
            t_bytes, t_ops = nbytes / bw * 1e3, 2 * m * n * k / peak * 1e3
            row = {
                "name": "q4_lut_post", "n": n, "k": k, "m": m,
                "ms": clean(lambda: gemv.q4_lut_post(x, *fargs),
                            reps=args.reps),
                "ms_dirty_l2": dirty(lambda: gemv.q4_lut_post(x, *fargs),
                                     reps=args.reps),
                "library_ms": clean(lambda: torch.matmul(x, w_bf16.t()),
                                    reps=args.reps),
                "library_ms_dirty_l2": dirty(
                    lambda: torch.matmul(x, w_bf16.t()), reps=args.reps),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "rel_err": err / scale, "ok": ok}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            emit(row)
            if not ok:
                raise RuntimeError(f"kernel A n={n} k={k} m={m}: {err} > "
                                   f"1e-2 * {scale}")
            for key in ("ms", "ms_dirty_l2", "library_ms",
                        "library_ms_dirty_l2", "bound_ms"):
                layer[m][key] = layer[m].get(key, 0.0) + \
                    cs.LAYER_LINEARS.get((n, k), 0) * row[key]
        del qt, w_bf16
    for m, sums in layer.items():
        emit({"name": "layer", "m": m, "linears": 7, **sums})


if __name__ == "__main__":
    main()
