"""Serving cells (traffic ``kind`` ``serve``): ``Engine.step`` fed by the
traffic file's ``arrivals``:

- ``{"process": "closed"}`` (the default): a closed loop of ``clients``,
  each sending its next request when its last one finishes; the first
  wave is in flight when the window opens.
- ``{"process": "poisson", "rate": r, "group": g}``: an open loop,
  requests arriving at ``r`` a second in groups of ``g`` (1: Poisson
  arrivals; more: bursts), whatever the engine has finished.
"""
from __future__ import annotations

import time


def _loop(engine, traffic, vocab, seed):
    from .. import drive, inputs
    arrivals = traffic.get("arrivals", {"process": "closed"})
    burst = traffic["engine"]["burst"]
    if arrivals["process"] == "closed":
        return drive.ClosedLoop(
            engine, inputs.client_requests(traffic, vocab, seed), burst)
    if arrivals["process"] == "poisson":
        return drive.OpenLoop(
            engine, inputs.open_arrivals(traffic, vocab, seed), burst)
    raise ValueError(f"unknown arrival process {arrivals['process']!r}")


def run(cell, seed, seconds, trace, device, t_start, control):
    """One run of a serving cell, and the sample of what its window
    finished judged by the logit gaps."""
    import numpy as np

    from any4_tpu_torch.serving.engine import Engine

    from .. import drive, inputs, measure, program
    from ..reference import compare
    config, traffic = cell.config, cell.traffic
    build_s = program.build_kernels(device)
    cfg = program.model_config(config)
    params = program.build_params(config, seed, device)
    ek = traffic["engine"]
    engine = Engine(params, cfg, max_slots=ek["max_slots"],
                    max_ctx=ek["max_ctx"], page_size=ek["page_size"],
                    kv_layout=ek["kv_layout"], device=device)
    loop = _loop(engine, traffic, cfg.vocab_size, seed)
    loop.warm(inputs.lengths(traffic["prompt_len"], traffic["pool"]))
    loop.first_wave()
    prof = measure.profiler(trace)
    setup_s = time.perf_counter() - t_start
    res = loop.window(seconds, traffic["trace_seconds"] if trace else 0.0,
                      prof)
    peak, clocks = measure.peak(device), measure.clocks(device)
    span = res.window[1] - res.window[0]
    e2e = {"output_tok_s": res.tokens / span,
           "itl_p95_ms": drive.percentile(res.gaps, 0.95) * 1e3,
           "ttft_p95_ms": drive.percentile(res.ttft, 0.95) * 1e3,
           "setup_s": setup_s}
    rng = np.random.default_rng(inputs.subseed(seed, 6))
    sample = measure.sample(rng, res.finished, lambda s: s.seen,
                            traffic["check_tokens"], longest=True)
    served = [(s.req.prompt.copy(), list(s.req.out_tokens)) for s in sample]
    # every request the window served or sent
    attempted = sum(1 for s in res.sent if s.in_window or s.done is None
                    or s.done >= res.window[0])
    info = dict(steps=res.steps, window=res.window, trace=res.trace,
                attempted=attempted, failed=res.failed, peak=peak, e2e=e2e,
                build_s=build_s, clocks=clocks)
    del loop, engine, params, res, sample
    measure.free(device)
    checks = (compare.logit_gap(config, seed, device, served, control)
              if served else {})
    return info, checks
