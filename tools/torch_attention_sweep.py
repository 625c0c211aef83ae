#!/usr/bin/env python3
"""Time the port's four decode-attention kernels on one NVIDIA GPU across
split lengths, each held against its plain version.

    python3 tools/torch_attention_sweep.py [--root DIR] [--splits 64,128,...]
        [--cases 1x2048,8x2048,8x8192] [--out FILE]

For each kernel, each (slots, context) case at the 1B serving shapes of
``chip_smoke.py`` (8 kv heads, rep 4, head_dim 64, page size 16, bf16 q,
bf16 or int8 pools, every slot at full length), and each split length S, it
checks the kernel against its plain version at the bars of ``chip_smoke.py``
(1e-2 * max for bf16 pools, 2e-2 for int8) and prints one JSON row with the
kernel's median time (CUDA events, L2 flushed before each launch; a
first ``floor`` row times a kernel that writes 4 bytes the same way),
``scaled_dot_product_attention`` over a dense bf16 view of the same pools
(``library_ms``) and the bytes bound. The ``clean_l2`` times repeat the
kernel's and the library call's with the L2 emptied by reading the 128 MB
buffer instead of writing it: a write leaves dirty lines that the timed
kernel's misses must write back first. ``--splits default`` (the default)
takes ``kv_cache.split_len``.

``--root DIR`` imports ``any4_tpu_torch`` and ``chip_smoke.py`` from another
checkout (for example the parent commit unpacked with ``git archive``) and
times its kernels (at its own split lengths where it has ``split_len``): the
way to compare two versions within one call on one card. Rows also go to
``--out`` (JSON lines).
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


class _ReadFlush:
    """Stands in for the flush buffer of a ``chip_smoke.Timer`` that writes
    it (checkouts before the timer read it): ``zero_`` reads it."""

    def __init__(self, buf):
        self.buf = buf.zero_()

    def zero_(self):
        return self.buf.amax()


def timers(cs):
    """``chip_smoke`` module ``cs``'s timers, (L2 emptied by writing the
    128 MB buffer, by reading it), whichever way its ``Timer`` flushes."""
    import torch
    if "dirty" in inspect.signature(cs.Timer).parameters:
        return cs.Timer(dirty=True), cs.Timer()
    clean = cs.Timer()
    clean.flush = _ReadFlush(clean.flush.view(torch.float32))
    return cs.Timer(), clean


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--splits", default="default")
    ap.add_argument("--cases", default="1x2048,8x2048,8x8192")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_sweep: no CUDA device", file=sys.stderr)
        sys.exit(1)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, REPO)
    import chip_smoke as cs
    from any4_tpu_torch.ops import build
    from any4_tpu_torch.serving import kv_cache as kvc
    if os.path.dirname(os.path.abspath(kvc.__file__)) != os.path.join(
            root, "any4_tpu_torch", "serving"):
        raise RuntimeError(f"imported {kvc.__file__}, not from {root}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    bw = cs.peaks(torch.cuda.get_device_name(0))[1][0]
    version = "this tree" if root == REPO else root
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row = {"nvidia_smi": smi, "version": version, **row}
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()

    cases = [tuple(int(x) for x in c.split("x"))
             for c in args.cases.split(",")]
    sweep = hasattr(kvc, "split_len")
    default_split = getattr(kvc, "split_len", None)
    # the clean timer reads the 128 MB buffer between launches, so the
    # timed kernel's misses evict no dirty lines
    timer, clean = timers(cs)
    gen = torch.Generator(device="cuda").manual_seed(3)
    # the timer's floor: one launch of a kernel that writes 4 bytes
    tiny = torch.empty(1, device="cuda")
    emit({"name": "floor", "ms": timer(tiny.zero_)})
    build.compile_source(kvc._SOURCE, verbose=True)
    for name, (layout, q8, _) in cs.ATTN_KERNELS.items():
        pool_dtype = torch.int8 if q8 else torch.bfloat16
        tol = 2e-2 if q8 else 1e-2
        for b, ctx in cases:
            fn, plain, fargs = cs.attn_inputs(kvc, name, b, ctx, gen,
                                              pool_dtype, torch.bfloat16)
            library_ms = timer(cs.sdpa_yardstick(kvc, fargs))
            library_clean_ms = clean(cs.sdpa_yardstick(kvc, fargs))
            bound, by, nbytes, _ = cs.attn_bound(name, fargs, bw)
            if not sweep:
                splits = [None]
            elif args.splits == "default":
                splits = [default_split(b, cs.ATTN_HEADS)]
            else:
                splits = [int(s) for s in args.splits.split(",")]
            for split in splits:
                if split is not None:
                    kvc.split_len = (lambda s: lambda b_, h_: s)(split)
                y, ref = fn(*fargs), plain(*fargs)
                torch.cuda.synchronize()
                err = float((y.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                ok = bool(torch.isfinite(y).all()) and err <= tol * scale
                ms = timer(lambda: fn(*fargs))
                clean_ms = clean(lambda: fn(*fargs))
                emit({"name": name, "b": b, "ctx": ctx, "S": split,
                      "ms": ms, "clean_l2_ms": clean_ms,
                      "library_clean_l2_ms": library_clean_ms,
                      "library_ms": library_ms, "bound_ms": bound,
                      "bound_by": by, "bound_share": bound / ms,
                      "gb_per_s": nbytes / ms / 1e6,
                      "rel_err": err / scale, "ok": ok})
                if not ok:
                    raise RuntimeError(f"{name} b={b} ctx={ctx} S={split}: "
                                       f"{err} > {tol} * {scale}")
            if sweep:
                kvc.split_len = default_split
            del fargs


if __name__ == "__main__":
    main()
