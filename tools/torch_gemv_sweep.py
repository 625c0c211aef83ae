#!/usr/bin/env python3
"""Time the port's quantized linear kernels on one NVIDIA GPU at the 1B
linear shapes across m, each held against its plain version.

    python3 tools/torch_gemv_sweep.py [--root DIR] [--kernels q4_lut_post]
        [--ms 1,8,16,128,512] [--shapes 2048x2048,512x2048,8192x2048,2048x8192]
        [--group-size G] [--reps 20] [--out FILE]

``--kernels`` takes a comma-separated list of ``q4_lut_post`` (kernel A,
any4 with per-row LUTs; the default), ``q4_lut_fused`` (kernel B, any4
with per-row LUTs at g=64), ``q4_int4_magic`` (kernel C, int4),
``q4_lut_select`` (kernel E, int4 with the ramp LUT), ``int8_post`` (int8
codes), ``int8_fused`` (int8 codes at g=64), ``w4a8`` (kernel D: int8
activations, 4-bit codes), ``w8a8`` (int8 activations and codes),
``w4a8_fused`` and ``w8a8_fused`` (D-fused and ``w8a8_fused``: bf16
activations, which they quantize themselves), all at g=128 but B and
``int8_fused``; ``--group-size`` sets one group size for all of them (for
example 128, to time B beside A on the same kind of operands). For each
kernel, (n, k) shape and m it
checks the kernel's output against the plain version (bf16 within 1e-2 *
max, ``chip_smoke.py``'s bar; D and ``w8a8`` give f32, within 1e-5 * max:
their integer dots are exact) and prints one
JSON row with the kernel's median time (CUDA events over ``--reps``
launches; ``ms`` with the L2 emptied by reading a 128 MB buffer before each
launch, ``ms_dirty_l2`` by writing it), the plain version's (``plain_ms``,
5 launches), one bf16 ``torch.matmul`` on the dequantized weight
(``library_ms``, the same two ways; the port never calls it) and the least
time the card could take (``bound_ms``: the bytes over the
memory rate, or 2mnk over the tensor cores' bf16 rate (int8 for the four
W4A8/W8A8 kernels), the larger). A last ``layer`` row per kernel and m sums
one Llama-3.2-1B decoder layer's 7 linears.

To time ``int8_fused`` beside the kernels that share its bodies against a
parent checkout, in one call (parent, this tree, this tree, parent)::

    python3 tools/torch_gemv_sweep.py --kernels int8_fused,q4_lut_post,\
        q4_int4_magic,int8_post,q4_lut_fused,q4_lut_select \
        --ms 1,8,16,32,128,512 --root chip_check/parent

``--root DIR`` imports ``any4_tpu_torch`` and ``chip_smoke.py`` from another
checkout (for example the parent commit unpacked with ``git archive``) and
times its kernels: the way to compare two versions within one call on one
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
# kernel -> (format of its QuantizedTensor, int8 codes, activations: bf16,
# int8, or bf16 that the kernel quantizes to int8; group size)
KERNELS = {"q4_lut_post": ("any4", False, "bf16", 128),
           "q4_lut_fused": ("any4", False, "bf16", 64),
           "q4_int4_magic": ("int4", False, "bf16", 128),
           "q4_lut_select": ("int4", False, "bf16", 128),
           "int8_post": ("int8", True, "bf16", 128),
           "int8_fused": ("int8", True, "bf16", 64),
           "w4a8": ("int4", False, "int8", 128),
           "w8a8": ("int8", True, "int8", 128),
           "w4a8_fused": ("int4", False, "quantized", 128),
           "w8a8_fused": ("int8", True, "quantized", 128)}
# the kernels that take a LUT (the int4 format's is the ramp), here and in
# an older checkout
LUT_KERNELS = ("q4_lut_post", "q4_lut_fused", "q4_lut_select")


def operands(torch, linear, packing, fmt, int8_codes, n, k, g, gen):
    """Random codes in the port's layout (int8 codes with -128, or 4-bit),
    g-wide scales and zeros and, for any4, a sorted per-row LUT, as a
    ``QuantizedTensor``."""
    if int8_codes:
        packed = packing.pack_codes8(torch.randint(
            -128, 128, (n, k), generator=gen, device="cuda",
            dtype=torch.int8))
    else:
        packed = packing.pack_codes(torch.randint(
            0, 16, (n, k), generator=gen, device="cuda", dtype=torch.uint8))
    lut = None
    if fmt == "any4":
        lut = (torch.sort(torch.rand((n, 16), generator=gen, device="cuda"),
                          dim=1).values * 15.0 - 8.0).contiguous()
    G = packing.padded_k(k) // g
    scales = torch.rand((G, n), generator=gen, device="cuda") * 0.01 + 1e-3
    zeros = torch.randn((G, n), generator=gen, device="cuda") * 0.01
    return linear.QuantizedTensor(packed, scales, zeros, lut, fmt, g, (n, k))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--kernels", default="q4_lut_post")
    ap.add_argument("--ms", default="1,8,16,128,512")
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--group-size", type=int, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    names = args.kernels.split(",")
    unknown = [name for name in names if name not in KERNELS]
    if unknown:
        ap.error(f"unknown kernels {unknown}; choose from {list(KERNELS)}")
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

    build.build_all(verbose=True)
    dirty, clean = timers(cs)
    ms_list = [int(m) for m in args.ms.split(",")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in names:
        fmt, int8_codes, x_kind, g = KERNELS[name]
        g = args.group_size or g
        int8_x = x_kind == "int8"
        wrapper, plain = getattr(gemv, name), getattr(gemv, name + "_plain")
        out_dtype, bar = ((torch.float32, 1e-5) if int8_x
                          else (torch.bfloat16, 1e-2))
        rate = peak if x_kind == "bf16" else cs.INT8_OPS
        layer = {m: {} for m in ms_list}
        for shape in args.shapes.split(","):
            n, k = (int(v) for v in shape.split("x"))
            qt = operands(torch, linear, packing, fmt, int8_codes, n, k, g,
                          gen)
            w_bf16 = linear.dequantize_tensor(qt, torch.bfloat16)
            lut = qt.lut if fmt == "any4" else gemv.int4_ramp("cuda")
            wargs = (qt.packed, qt.scales, qt.zeros) \
                + ((lut,) if name in LUT_KERNELS else ()) \
                + (g, out_dtype)
            pargs = wargs[:3] + ((None,) if name == "q4_int4_magic"
                                 else ()) + wargs[3:]
            for m in ms_list:
                x = torch.randn((m, k), generator=gen, device="cuda")
                x = (torch.randint(-127, 128, (m, k), generator=gen,
                                   device="cuda", dtype=torch.int8)
                     if int8_x else x.to(torch.bfloat16))
                xb = x.to(torch.bfloat16)
                y = wrapper(x, *wargs)
                ref = plain(x, *pargs)
                torch.cuda.synchronize()
                err = float((y.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                ok = bool(torch.isfinite(y).all()) and err <= bar * scale
                nbytes = (qt.packed.numel() * qt.packed.element_size()
                          + 2 * qt.scales.numel() * 4
                          + (lut.numel() * 4 if name in LUT_KERNELS else 0)
                          + x.numel() * x.element_size()
                          + y.numel() * y.element_size())
                t_bytes, t_ops = nbytes / bw * 1e3, 2 * m * n * k / rate * 1e3
                row = {
                    "name": name, "n": n, "k": k, "m": m, "group_size": g,
                    "ms": clean(lambda: wrapper(x, *wargs), reps=args.reps),
                    "ms_dirty_l2": dirty(lambda: wrapper(x, *wargs),
                                         reps=args.reps),
                    "plain_ms": clean(lambda: plain(x, *pargs), reps=5),
                    "library_ms": clean(lambda: torch.matmul(xb, w_bf16.t()),
                                        reps=args.reps),
                    "library_ms_dirty_l2": dirty(
                        lambda: torch.matmul(xb, w_bf16.t()), reps=args.reps),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "rel_err": err / scale, "bar": bar, "ok": ok}
                row["bound_share"] = row["bound_ms"] / row["ms"]
                emit(row)
                if not ok:
                    raise RuntimeError(f"{name} n={n} k={k} m={m}: {err} > "
                                       f"{bar} * {scale}")
                for key in ("ms", "ms_dirty_l2", "plain_ms", "library_ms",
                            "library_ms_dirty_l2", "bound_ms"):
                    layer[m][key] = layer[m].get(key, 0.0) + \
                        cs.LAYER_LINEARS.get((n, k), 0) * row[key]
            del qt, w_bf16
        for m, sums in layer.items():
            emit({"name": "layer", "kernel": name, "m": m, "linears": 7,
                  **sums})


if __name__ == "__main__":
    main()
