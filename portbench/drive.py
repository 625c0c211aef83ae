"""The timed paths: a closed or an open loop of requests over
``Engine.step``, and offline scoring through
``evals.perplexity.eval_perplexity_chunked``.

Each call of the program is wrapped in a ``record_function`` span
(``portbench.admit`` when the harness sees requests pending before the
call, ``portbench.decode`` otherwise, ``portbench.client`` around the
clients' bookkeeping, ``portbench.score`` around a window) and timed by
the host clock; every call ends on the host (tokens or a perplexity read
back), so each time covers the device work it launched.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
from torch.profiler import record_function

from .record import Step, Trace


def _launches() -> int:
    from any4_tpu_torch.ops import gemv
    from any4_tpu_torch.serving import kv_cache
    return sum(gemv.LAUNCHES.values()) + sum(kv_cache.LAUNCHES.values())


def prefill_buckets(lengths, max_ctx: int, smallest: int) -> dict:
    """{bucket: the longest prompt of ``lengths`` that lands in it}, for
    the engine's power-of-two prefill buckets."""
    out = {}
    for t in lengths:
        t = min(int(t), max_ctx - 1)
        b = smallest
        while b < t:
            b *= 2
        b = min(b, max_ctx)
        out[b] = max(out.get(b, 0), t)
    return out


@dataclass
class Sent:
    req: object               # the engine's Request
    client: int
    prompt_len: int
    max_new: int
    sent: float
    in_window: bool
    seen: int = 0
    first: Optional[float] = None
    last: Optional[float] = None
    done: Optional[float] = None


@dataclass
class ServeResult:
    steps: List[Step]
    window: tuple
    tokens: int
    gaps: List[float]
    ttft: List[float]
    sent: List[Sent]
    failed: int = 0
    finished: List[Sent] = field(default_factory=list)
    trace: Optional[Trace] = None


class ClosedLoop:
    """Callers each sending their next request (``requests[client]``, in
    turn) as soon as their last one finishes, into an ``Engine``."""

    def __init__(self, engine, requests, burst: int = 1):
        self.engine = engine
        self.queues = requests
        self.next = [0] * len(requests)
        self.burst = burst
        self.inflight: List[Sent] = []
        self.all: List[Sent] = []
        self.gaps: List[float] = []
        self.finished: List[Sent] = []
        self.failed = 0
        self._w0 = math.inf

    def _send(self, client: int, now: float, in_window: bool) -> None:
        q = self.queues[client]
        r = q[self.next[client] % len(q)]
        self.next[client] += 1
        self.engine.submit(r.prompt, max_new_tokens=r.max_new_tokens)
        s = Sent(self.engine.pending[-1], client, len(r.prompt),
                 r.max_new_tokens, now, in_window)
        self.inflight.append(s)
        self.all.append(s)

    def warm(self, lengths) -> None:
        """One request of every prefill bucket ``lengths`` lands in, run
        to its end (two tokens), through the engine's own calls."""
        e = self.engine
        buckets = prefill_buckets(lengths, e.max_ctx, e.MIN_PREFILL_BUCKET)
        ids = np.concatenate([q[0].prompt for q in self.queues])
        for _, t in sorted(buckets.items()):
            e.submit(ids[:t], max_new_tokens=2)
            while e.pending or any(s is not None for s in e.slots):
                e.step(self.burst)
        e.finished.clear()

    def first_wave(self) -> None:
        """Every client's first request, sent and admitted before the
        window opens."""
        now = time.perf_counter()
        for c in range(len(self.queues)):
            self._send(c, now, in_window=False)
        self._step(traced=False, in_window=False, send=True)

    def _step(self, traced: bool, in_window: bool, send: bool) -> Step:
        """One ``Engine.step`` and the clients' bookkeeping after it: the
        tokens each request got, its gaps, and for each finished request
        the client's next one (``send``)."""
        kind = "admit" if self.engine.pending else "decode"
        l0 = _launches()
        with record_function("portbench." + kind):
            t0 = time.perf_counter()
            self.engine.step(self.burst)
            t1 = time.perf_counter()
        step = Step(t0, t1, kind, launches=_launches() - l0, traced=traced)
        with record_function("portbench.client"):
            still = []
            for s in self.inflight:
                n = len(s.req.out_tokens)
                got = n - s.seen
                if got > 0:
                    if s.seen == 0:
                        step.prefill.append(s.prompt_len)
                        s.first = t1
                    if n >= 2 and (s.seen > 0 or got >= 2):
                        step.decode_ctx.append(s.prompt_len + n - 1)
                    if in_window:
                        step.tokens += got
                        if s.last is not None and s.last >= self._w0:
                            self.gaps.append(t1 - s.last)
                            self.gaps.extend([0.0] * (got - 1))
                    s.seen, s.last = n, t1
                if s.req.done:
                    s.done = t1
                    if in_window:
                        self.finished.append(s)
                    if s.seen < s.max_new:
                        self.failed += 1
                    if send:
                        self._send(s.client, t1, in_window)
                else:
                    still.append(s)
            self.inflight = still
        return step

    def window(self, seconds: float, trace_seconds: float = 0.0,
               profiler=None, drain_s: float = 60.0) -> ServeResult:
        """Steps until ``seconds`` have passed; with ``profiler``, from
        ``seconds - trace_seconds`` on under the profiler, and on until
        ``trace_seconds`` of traced steps have passed. Then, sending
        nothing more, steps until every request sent in the window has its
        first token (at most ``drain_s``)."""
        self.gaps, self.finished, self.failed = [], [], 0
        steps = []
        self._w0 = w0 = time.perf_counter()
        clock = _TraceClock(profiler, seconds, trace_seconds, w0)
        while True:
            clock.tick()
            steps.append(self._step(clock.on, in_window=True, send=True))
            if clock.done(steps[-1].t1):
                break
        return self._close(steps, w0, steps[-1].t1, clock, drain_s)

    def _close(self, steps, w0, w1, clock, drain_s) -> ServeResult:
        """The window's result once it has ended at ``w1``: the trace, and
        every request sent in it stepped to its first token."""
        trace = clock.profiler.stop() if clock.on else None
        tokens = sum(s.tokens for s in steps)
        deadline = time.perf_counter() + drain_s
        while any(s.in_window and s.first is None for s in self.all) \
                and time.perf_counter() < deadline:
            self._step(False, in_window=False, send=False)
        ttft = [s.first - s.sent for s in self.all
                if s.in_window and s.first is not None]
        missing = sum(1 for s in self.all if s.in_window and s.first is None)
        return ServeResult(steps, (w0, w1), tokens, self.gaps, ttft,
                           self.all, self.failed + missing, self.finished,
                           trace)


class OpenLoop(ClosedLoop):
    """Requests arriving at fixed offsets from the window's opening
    (``arrivals``: ``(offset seconds, request)``, in order of offset),
    whatever the engine has finished. A request's time to first token
    counts from its arrival."""

    def __init__(self, engine, arrivals, burst: int = 1):
        super().__init__(engine, [[r] for _, r in arrivals], burst)
        self.offsets = [t for t, _ in arrivals]

    def first_wave(self) -> None:
        """Nothing is in flight when an open loop's window opens."""

    def _idle(self) -> bool:
        e = self.engine
        return not e.pending and all(s is None for s in e.slots)

    def window(self, seconds: float, trace_seconds: float = 0.0,
               profiler=None, drain_s: float = 60.0) -> ServeResult:
        """As :meth:`ClosedLoop.window`, with each request sent at its
        arrival; while nothing is in flight the loop waits for the next
        one."""
        self.gaps, self.finished, self.failed = [], [], 0
        steps = []
        self._w0 = w0 = time.perf_counter()
        clock = _TraceClock(profiler, seconds, trace_seconds, w0)
        nxt = 0
        while True:
            now = time.perf_counter()
            while nxt < len(self.offsets) and w0 + self.offsets[nxt] <= now:
                self._send(nxt, w0 + self.offsets[nxt], in_window=True)
                nxt += 1
            clock.tick()
            if self._idle():
                if clock.done(now):
                    break
                wake = w0 + (self.offsets[nxt] if nxt < len(self.offsets)
                             else seconds)
                time.sleep(max(0.0, min(wake, now + 0.05)
                               - time.perf_counter()))
                continue
            steps.append(self._step(clock.on, in_window=True, send=False))
            if clock.done(steps[-1].t1):
                break
        return self._close(steps, w0, time.perf_counter(), clock, drain_s)


class _TraceClock:
    """When the profiled part of a window starts and when the window ends:
    the profiler starts at ``seconds - trace_seconds`` and the window lasts
    ``seconds``, and under a profiler at least ``trace_seconds`` of traced
    calls besides (the profiler's start is not counted)."""

    def __init__(self, profiler, seconds, trace_seconds, w0):
        self.profiler, self.seconds, self.w0 = profiler, seconds, w0
        self.trace_seconds = trace_seconds
        self.on = False
        self.t_on = None

    def tick(self):
        if self.profiler is not None and not self.on and \
                time.perf_counter() - self.w0 >= self.seconds \
                - self.trace_seconds:
            self.profiler.start()
            self.on, self.t_on = True, time.perf_counter()

    def done(self, t: float) -> bool:
        """Does the window end at ``t``, the end of a call?"""
        if t - self.w0 < self.seconds:
            return False
        return self.profiler is None or (
            self.on and t - self.t_on >= self.trace_seconds)


def score_window(params, cfg, windows, seconds: float, trace_seconds=0.0,
                 profiler=None):
    """Windows scored one a call (``eval_perplexity_chunked``, batch 1)
    until ``seconds`` have passed, with ``profiler`` as
    :meth:`ClosedLoop.window` runs it. Returns ``(steps, (start, end),
    [(window index, perplexity)], trace)``."""
    from any4_tpu_torch.evals import perplexity
    dev = "cuda" if params["norm"].is_cuda else "cpu"
    L = len(windows[0])
    steps, answers = [], []
    w0 = time.perf_counter()
    clock = _TraceClock(profiler, seconds, trace_seconds, w0)
    i = 0
    while True:
        clock.tick()
        l0 = _launches()
        with record_function("portbench.score"):
            t0 = time.perf_counter()
            ppl = perplexity.eval_perplexity_chunked(
                params, cfg, windows[i % len(windows)], seqlen=L,
                batch_size=1, device=dev)
            t1 = time.perf_counter()
        steps.append(Step(t0, t1, "score", prefill=[L],
                          launches=_launches() - l0, traced=clock.on,
                          tokens=L - 1))
        answers.append((i % len(windows), ppl))
        i += 1
        if clock.done(steps[-1].t1):
            break
    trace = profiler.stop() if clock.on else None
    return steps, (w0, steps[-1].t1), answers, trace


def percentile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by linear interpolation (numpy's
    default), or NaN for none."""
    if not values:
        return math.nan
    return float(np.percentile(np.asarray(values, np.float64), q * 100))
