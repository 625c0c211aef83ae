#!/usr/bin/env python3
"""Run the PyTorch port (``any4_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--layers N]

Phases, each printing JSON lines:

1. setup: the card's ``nvidia-smi`` name and power limit, the torch and CUDA
   versions, and the time to build the CUDA kernels from
   ``any4_tpu_torch/ops/csrc`` with nvcc.
2. kernels: kernel A (``q4_lut_post``, g=128) and kernel B
   (``q4_lut_fused``, g=64) at Llama-3.2-1B's linear shapes and m in
   {1, 16, 128}, each held against its plain PyTorch version on the card
   (bf16 output within 1e-2 * max|plain|), with its time (CUDA events,
   median, L2 flushed before each launch), the plain version's time, one
   ``torch.matmul`` on the dequantized bf16 weight as a yardstick
   (``library_ms``; the port never calls it) and the least time the card
   could take (``bound_ms``). Then both kernels on edge cases (odd n and
   k, a misaligned x, float32/float16 outputs, a global LUT) against their
   plain versions.
3. main path: Llama-3.2-1B at full width and all 16 layers (``--layers``
   cuts the depth), bf16 weights from ``init_params(seed=0)``, quantized by
   ``quantize_model(fmt="any4", group_size=128, kmeans_iters=10)``; its
   prefill logits with float32 activations are held within 2e-2 * max of
   the dequantized weights' dense float32 forward, and
   ``generate`` runs a seeded 64-token prompt for 64 greedy tokens at batch 1
   and 4. Kernel A must launch exactly 112 times (16 layers x 7 linears) per
   forward; the dense bf16 model's decode figures are printed beside.
   Then the same entry points at g=64, which runs kernel B (2 layers).
4. the ``nvidia-smi`` name and power line again, then the line
   ``{"kernels": [...]}``, one entry per kernel.
5. ``{"ok": true, "device": {...}}`` as the last line.

Any failed check raises, and the script exits non-zero before the last line.
Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

# H100 data-sheet peaks (SXM part, dense, at the 700 W limit); the PCIe
# part has its own. bytes/s, bf16 FLOP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100": (3.35e12, 989e12)}
KERNEL_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
# one Llama-3.2-1B decoder layer: q, k, v, o, gate, up, down
LAYER_LINEARS = {(2048, 2048): 2, (512, 2048): 2, (8192, 2048): 2,
                 (2048, 8192): 1}
KERNELS = {
    "q4_lut_post": dict(group_size=128, replaces=(
        "any4_tpu/ops/pallas/gemv.py:230 _q4t_kernel; "
        "any4_tpu/ops/pallas/gemv.py:172 _q4post_kernel")),
    "q4_lut_fused": dict(group_size=64, replaces=(
        "any4_tpu/ops/pallas/gemv.py:106 _q4_kernel")),
}
SOURCE = "any4_tpu_torch/ops/csrc/q4_lut_gemv.cu"
PROMPT_LEN = 64
NEW_TOKENS = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


class Timer:
    """Median device time of ``fn`` over ``reps`` launches, each timed by
    its own pair of CUDA events after the 50 MB L2 cache is overwritten.
    The device first spins for ~50 ms, so the host queues every launch
    before the first one runs and the events see no host time."""

    def __init__(self):
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        for start, end in events:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_phase(gemv, packing, linear, timer, bw, peak):
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, spec in KERNELS.items():
        g = spec["group_size"]
        wrapper = getattr(gemv, name)
        plain = getattr(gemv, name + "_plain")
        for n, k in KERNEL_SHAPES:
            codes = torch.randint(0, 16, (n, k), generator=gen, device="cuda",
                                  dtype=torch.uint8)
            lut = torch.sort(torch.rand((n, 16), generator=gen,
                                        device="cuda"), dim=1).values
            lut = (lut * 15.0 - 8.0).contiguous()
            G = packing.padded_k(k) // g
            scales = torch.rand((G, n), generator=gen, device="cuda") * 0.01 \
                + 1e-3
            zeros = torch.randn((G, n), generator=gen, device="cuda") * 0.01
            qt = linear.QuantizedTensor(packing.pack_codes(codes), scales,
                                        zeros, lut, "any4", g, (n, k))
            w_bf16 = linear.dequantize_tensor(qt, torch.bfloat16)
            args = (qt.packed, qt.scales, qt.zeros, qt.lut, g, torch.bfloat16)
            for m in (1, 16, 128):
                x = torch.randn((m, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                y = wrapper(x, *args)
                ref = plain(x, *args)
                torch.cuda.synchronize()
                err = float((y.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                check(bool(torch.isfinite(y).all()), f"{name} finite")
                check(err <= 1e-2 * scale,
                      f"{name} n={n} k={k} m={m}: |kernel - plain| {err} > "
                      f"1e-2 * {scale}")
                nbytes = (qt.packed.numel() * 4 + 2 * G * n * 4 + n * 16 * 4
                          + m * k * 2 + m * n * 2)
                flops = 2 * m * n * k
                t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
                row = {
                    "phase": "kernel", "name": name, "n": n, "k": k, "m": m,
                    "group_size": g,
                    "ms": timer(lambda: wrapper(x, *args)),
                    "plain_ms": timer(lambda: plain(x, *args), reps=5),
                    "library_ms": timer(lambda: torch.matmul(x, w_bf16.t())),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "flops": flops,
                    "max_abs_err": err, "rel_err": err / scale,
                }
                row["gb_per_s"] = nbytes / row["ms"] / 1e6
                row["bound_share"] = row["bound_ms"] / row["ms"]
                emit(row)
                rows.append(row)
            del qt, w_bf16
    return rows


def edge_cases(gemv, packing):
    """Both kernels on shapes and operands the 1B path does not give them:
    n not a multiple of 8, k not a multiple of 8 or of 1024, m across the
    m-tile sizes, a misaligned x, float32/float16 outputs and a global LUT.
    float32 outputs match the plain version within 1e-4 * max (only the
    order of float32 sums differs), bf16/f16 within 1e-2 * max."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = 0
    for n, k, m in ((1000, 1000, 3), (7, 64, 17), (384, 1536, 40),
                    (130, 2056, 9)):
        kp = packing.padded_k(k)
        codes = torch.randint(0, 16, (n, k), generator=gen, device="cuda",
                              dtype=torch.uint8)
        packed = packing.pack_codes(codes)
        big = torch.randn((m + 1, k), generator=gen, device="cuda")
        for name, g in (("q4_lut_post", 128), ("q4_lut_fused", 16),
                        ("q4_lut_fused", 32)):
            G = kp // g
            scales = packing.pad_groups(torch.rand(
                (n, -(-k // g)), generator=gen, device="cuda") + 0.5, k, g)
            zeros = packing.pad_groups(torch.randn(
                (n, -(-k // g)), generator=gen, device="cuda"), k, g)
            args = (packed, scales.t().contiguous(), zeros.t().contiguous())
            for lut_rows in (n, 1):
                lut = torch.randn((lut_rows, 16), generator=gen,
                                  device="cuda") * 4
                for out, tol in ((torch.float32, 1e-4),
                                 (torch.bfloat16, 1e-2),
                                 (torch.float16, 1e-2)):
                    x = big.to(torch.bfloat16)[1:]   # offset by one row
                    y = getattr(gemv, name)(x, *args, lut, g, out)
                    ref = getattr(gemv, name + "_plain")(x, *args, lut, g,
                                                         out)
                    torch.cuda.synchronize()
                    err = rel_err(y, ref)
                    check(y.shape == (m, n) and y.dtype == out
                          and err <= tol,
                          f"{name} edge n={n} k={k} m={m} g={g} "
                          f"lut_rows={lut_rows} {out}: {err} > {tol}")
                    cases += 1
    return cases


def layer_summary(rows, name):
    """One Llama-3.2-1B decoder layer's 7 linears at m=1."""
    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for r in rows:
        if r["name"] == name and r["m"] == 1:
            for key in out:
                out[key] += LAYER_LINEARS[(r["n"], r["k"])] * r[key]
    mine = [r for r in rows if r["name"] == name]
    out["max_abs_err"] = max(r["max_abs_err"] for r in mine)
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in mine
                                     if r["m"] == 1) else "operations"
    return out


def rel_err(a, ref) -> float:
    """max |a - ref| over max |ref|."""
    ref = ref.float()
    return float((a.float() - ref).abs().max() / ref.abs().max())


def to_float32(tree, linear, dequantize=False):
    """Dense leaves as float32; quantized weights kept, or dequantized in
    float32 (``lut[c] * s + z``, not rounded to bf16)."""
    if isinstance(tree, dict):
        return {k: to_float32(v, linear, dequantize) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_float32(v, linear, dequantize) for v in tree]
    if isinstance(tree, linear.QuantizedTensor):
        return linear.dequantize_tensor(tree, torch.float32) if dequantize \
            else tree
    return tree.float()


def timed_generate(gen_mod, params, cfg, prompt):
    """``generate`` with host time, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = gen_mod.generate(params, cfg, prompt, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    return tokens, (time.perf_counter() - t0) * 1e3


def decode_figures(gen_mod, llama, params, cfg, prompt):
    """Host time of ``prefill`` and of ``decode_loop`` over the remaining
    NEW_TOKENS-1 steps, each ending in a synchronize; the better of two
    runs at each batch size."""
    out = {}
    for b in (1, 4):
        best = None
        for _ in range(2):
            caches = llama.init_kv_caches(cfg, b, PROMPT_LEN + NEW_TOKENS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = gen_mod.prefill(params, cfg, prompt[:b].long(),
                                             caches)
            tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gen_mod.decode_loop(params, cfg, tok, PROMPT_LEN, caches,
                                NEW_TOKENS - 1)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            run = ((t1 - t0) * 1e3, (t2 - t1) * 1e3 / (NEW_TOKENS - 1))
            best = run if best is None or run[1] < best[1] else best
        out[b] = {"prefill_ms": best[0], "decode_ms_per_token": best[1],
                  "tok_s": b * 1e3 / best[1]}
    return out


def device_profile(gen_mod, llama, params, cfg, prompt, steps=8):
    """Device time per decode step at batch 1 from ``torch.profiler``, and
    the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    caches = llama.init_kv_caches(cfg, 1, PROMPT_LEN + steps + 1)
    logits, caches = gen_mod.prefill(params, cfg, prompt[:1].long(), caches)
    tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gen_mod.decode_loop(params, cfg, tok, PROMPT_LEN, caches, steps)
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:       # kernels, not host ops
            t = ev.self_device_time_total
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + t
    total_ms = sum(per_kernel.values()) / 1e3 / steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms_per_step": total_ms,
            "top_kernels_ms_per_step": {k[:80]: v / 1e3 / steps
                                        for k, v in top}}


def main_path(args, gemv, llama, gen_mod, api, linear):
    cfg = llama.LlamaConfig.llama_3_2_1b()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=args.layers)
    per_forward = cfg.num_hidden_layers * 7
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    qparams = api.quantize_model(params, fmt="any4", group_size=128,
                                 kmeans_iters=10)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    quantized = [l for l in qparams["layers"] for l in l.values()
                 if isinstance(l, linear.QuantizedTensor)]
    check(len(quantized) == per_forward
          and all(q.fmt == "any4t" for q in quantized),
          "every linear is any4 at g=128")
    check("lm_head" not in qparams and isinstance(
        qparams["embed_tokens"], torch.Tensor), "tied lm_head stays bf16")

    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, PROMPT_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)

    # The check runs the any4 model with float32 activations (the kernels
    # still round x and the LUT to bf16, as the TPU kernels do) against the
    # dense float32 forward of the exactly dequantized weights. The bf16
    # model's figures are printed beside: over 16 random layers two bf16
    # forwards of the same weights already differ by 1.5-2e-2 of max.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    one = prompt[:1]
    logits = {
        "any4_f32": llama.forward(to_float32(qparams, linear), cfg32, one)[0],
        "any4_bf16": llama.forward(qparams, cfg, one)[0],
        "dense_bf16": llama.forward(api.dequantize_model(qparams), cfg,
                                    one)[0],
    }
    ref, _ = llama.forward(to_float32(qparams, linear, dequantize=True),
                           cfg32, one)
    torch.cuda.synchronize()
    errs = {f"rel_err_{k}_vs_dense_f32": rel_err(v, ref)
            for k, v in logits.items()}
    errs["rel_err_any4_bf16_vs_dense_bf16"] = rel_err(logits["any4_bf16"],
                                                      logits["dense_bf16"])
    emit({"phase": "main_path_check", "bar": 2e-2,
          "logits_max_abs": float(ref.abs().max()), **errs})
    check(all(bool(torch.isfinite(v).all()) for v in logits.values()),
          "any4 logits finite")
    check(errs["rel_err_any4_f32_vs_dense_f32"] <= 2e-2,
          "any4 prefill logits (float32 activations) vs the dequantized "
          f"model's float32 dense forward: {errs} > 2e-2 of max")
    del logits, ref

    # the main path: generate at batch 1 and 4, with the counts read around it
    torch.cuda.reset_peak_memory_stats()
    gemv.reset_launches()
    gen_ms, tokens = {}, {}
    for b in (1, 4):
        tokens[b], gen_ms[b] = timed_generate(gen_mod, qparams, cfg,
                                              prompt[:b])
    launches = dict(gemv.LAUNCHES)
    forwards = 2 * NEW_TOKENS  # per batch: one prefill + NEW_TOKENS-1 steps
    check(launches["q4_lut_post"] == per_forward * forwards,
          f"kernel A launches {launches['q4_lut_post']} != "
          f"{per_forward} x {forwards} forwards")
    check(launches["q4_lut_fused"] == 0, "kernel B is not on the g=128 path")
    for b, tok in tokens.items():
        check(tok.shape == (b, PROMPT_LEN + NEW_TOKENS), f"tokens shape b={b}")
        check(bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
              "tokens in vocab")
        check(torch.equal(tok[:, :PROMPT_LEN], prompt[:b]), "prompt kept")
    peak_mem = torch.cuda.max_memory_allocated()
    any4 = decode_figures(gen_mod, llama, qparams, cfg, prompt)
    prof = device_profile(gen_mod, llama, qparams, cfg, prompt)
    prof["busy_share_b1"] = (prof["device_ms_per_step"]
                             / any4[1]["decode_ms_per_token"])
    dense_tok, dense_ms = timed_generate(gen_mod, params, cfg, prompt[:1])
    dense = decode_figures(gen_mod, llama, params, cfg, prompt)
    dense_prof = device_profile(gen_mod, llama, params, cfg, prompt)
    dense_prof["busy_share_b1"] = (dense_prof["device_ms_per_step"]
                                   / dense[1]["decode_ms_per_token"])
    agree = float((tokens[1][:, PROMPT_LEN:] == dense_tok[:, PROMPT_LEN:])
                  .float().mean())
    emit({"phase": "main_path", "model": "llama_3_2_1b",
          "layers": cfg.num_hidden_layers, "fmt": "any4", "group_size": 128,
          "kmeans_iters": 10, "init_s": init_s, "quantize_s": quantize_s,
          "launches": launches, "launches_per_forward": per_forward,
          "generate_ms": gen_ms, "dense_generate_ms_b1": dense_ms,
          "max_memory_allocated": peak_mem,
          "model_bytes_any4": api.model_size_bytes(qparams),
          "model_bytes_bf16": api.model_size_bytes(params),
          "any4": any4, "dense_bf16": dense,
          "any4_profile_b1": prof, "dense_bf16_profile_b1": dense_prof,
          "greedy_agreement_with_dense_b1": agree,
          "b4_row0_equals_b1": bool(torch.equal(tokens[4][0], tokens[1][0]))})
    del params, qparams
    torch.cuda.empty_cache()

    # the same entry points at g=64 run kernel B (depth cut to 2 layers)
    cfg_b = dataclasses.replace(cfg, num_hidden_layers=2)
    qb = api.quantize_model(llama.init_params(cfg_b, seed=0, device="cuda"),
                            fmt="any4", group_size=64, kmeans_iters=10)
    gemv.reset_launches()
    tok_b = gen_mod.generate(qb, cfg_b, prompt[:1], max_new_tokens=16)
    torch.cuda.synchronize()
    launches_b = dict(gemv.LAUNCHES)
    check(launches_b["q4_lut_fused"] == 2 * 7 * 16 and
          launches_b["q4_lut_post"] == 0,
          f"g=64 path launches {launches_b}")
    check(bool(((tok_b >= 0) & (tok_b < cfg.vocab_size)).all()),
          "g=64 tokens in vocab")
    emit({"phase": "main_path_g64", "layers": 2, "new_tokens": 16,
          "launches": launches_b})
    return launches, launches_b


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the 1B model's depth (default: all 16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from any4_tpu_torch.models import generate as gen_mod, llama
    from any4_tpu_torch.ops import build, gemv, linear, packing
    from any4_tpu_torch.quant import api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_name, (bw, peak) = peaks(kind)
    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    emit({"phase": "setup", "nvidia_smi": smi, "device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "libraries": sorted(libs.values()),
          "bandwidth_bytes_per_s": bw, "bf16_flops_per_s": peak,
          "peaks_from": f"NVIDIA data sheet, {peak_name} (SXM unless PCIe)"})

    rows = kernel_phase(gemv, packing, linear, Timer(), bw, peak)
    emit({"phase": "kernel_edge_cases", "passed": edge_cases(gemv, packing)})
    launches, launches_b = main_path(args, gemv, llama, gen_mod, api, linear)

    kernels = []
    for name, spec in KERNELS.items():
        summary = layer_summary(rows, name)
        count = launches[name] if name == "q4_lut_post" else launches_b[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": spec["replaces"], "launches": count,
            "max_abs_err": summary["max_abs_err"], "ms": summary["ms"],
            "plain_ms": summary["plain_ms"], "bound_ms": summary["bound_ms"],
            "bound_by": summary["bound_by"],
            "library_ms": summary["library_ms"],
            "timed_as": "sum over one 1B decoder layer's 7 linears at m=1",
            "group_size": spec["group_size"]})
    print(smi, flush=True)      # the card's name and power limit
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
