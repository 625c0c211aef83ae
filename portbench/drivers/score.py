"""Scoring cells (traffic ``kind`` ``score``): windows through
``evals.perplexity.eval_perplexity_chunked`` at batch 1."""
from __future__ import annotations

import math
import time


def run(cell, seed, seconds, trace, device, t_start, control):
    """One run of a scoring cell: windows scored one a call, and a
    sample of them judged by the log-perplexity gap."""
    import numpy as np

    from any4_tpu_torch.evals import perplexity

    from .. import drive, inputs, measure, program
    from ..reference import compare
    config, traffic = cell.config, cell.traffic
    build_s = program.build_kernels(device)
    cfg = program.model_config(config)
    params = program.build_params(config, seed, device)
    windows = inputs.score_windows(traffic, cfg.vocab_size, seed,
                                   traffic["pool"])
    perplexity.eval_perplexity_chunked(params, cfg, windows[0],
                                       seqlen=traffic["seqlen"],
                                       device=device.type)
    prof = measure.profiler(trace)
    setup_s = time.perf_counter() - t_start
    steps, window, answers, tr = drive.score_window(
        params, cfg, windows, seconds,
        traffic["trace_seconds"] if trace else 0.0, prof)
    peak, clocks = measure.peak(device), measure.clocks(device)
    e2e = {"score_tok_s": sum(s.tokens for s in steps)
           / (window[1] - window[0]), "setup_s": setup_s}
    rng = np.random.default_rng(inputs.subseed(seed, 6))
    # one answer a window (a window scored twice is the same work)
    first = list({i: (i, p) for i, p in reversed(answers)}.values())
    sample = measure.sample(rng, first, lambda a: 1, traffic["check_windows"],
                     longest=False)
    failed = sum(1 for _, p in answers if not math.isfinite(p))
    info = dict(steps=steps, window=window, trace=tr,
                attempted=len(answers), failed=failed, peak=peak, e2e=e2e,
                build_s=build_s, clocks=clocks)
    del params
    measure.free(device)
    checks = compare.nll_gap(config, seed, device,
                             [windows[i] for i, _ in sample],
                             [p for _, p in sample], control)
    return info, checks
