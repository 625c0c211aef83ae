"""Spans inside the port, on the profiler's own clock.

A span marks one piece of host work at a layer boundary. It exists only
while ``torch.profiler`` is recording: :func:`span` then opens a profiler
event, and otherwise returns one shared no-op context, so an untraced
program pays one flag check a span (about 0.2 µs on an H100 machine's
host, against about 9 µs for an ungated ``record_function``). The spans
keep no clock, store nothing and export nothing: they are events in the
profiler's list, on the clock of the CUDA kernels it records. They are
recorded as operator events (``torch._C._profiler._RecordFunctionFast``),
not as user annotations, so the profiler draws no copy of them on the
device's timeline and they cost about 1.5 µs each while it records (11 µs
for ``record_function``).

To trace the port, run it under the profiler and export the timeline::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        engine.step()
    prof.export_chrome_trace("trace.json")

``record_shapes=True`` also records a span's ``args`` (a prefill's
request ``uid``, true length and bucket) in the event's ``kwinputs`` and
the timeline's ``args``.

The spans, which nest by time on the host thread (the enclosing span is
the parent):

- serving engine (:mod:`.serving.engine`): ``any4.engine.admit`` (the
  whole admission), ``any4.engine.prefill`` (one prompt; ``args`` uid,
  len, bucket), ``any4.engine.schedule`` (page reservations, retirements,
  the page table and the uploads before a decode), ``any4.engine.decode``
  (the dispatch of one decode step or burst), inside it
  ``any4.engine.graph`` (one step; ``args`` its page-table bucket and
  action: ``replay`` of the step's CUDA graph, ``capture`` of it after an
  eager run, or ``eager``; the model's spans open only in an eager step),
  ``any4.engine.read`` (the host's read of sampled tokens: its wait on the
  device), ``any4.engine.absorb`` (the bookkeeping after a decode's read);
- model (the decode step, :func:`.models.llama.forward`,
  :func:`.models.mixtral.forward`): ``any4.model.attn`` (norm through
  ``o_proj`` and the residual, RoPE and the KV writes included),
  ``any4.model.ffn`` (norm, MLP or routed experts, residual),
  ``any4.model.head`` (final norm and LM head); inside them
  ``any4.moe.route`` and ``any4.moe.experts``
  (:func:`.models.mixtral.moe_ffn`), ``any4.attn.prefill``
  (:func:`.models.llama.attention`'s float32 core) and ``any4.kv.write``
  (KV writes: a decode step's into the pools, a forward's into its dense
  caches, a prefill's page scatter);
- linear dispatch: ``any4.linear``, the body of
  :func:`.ops.linear.linear`.

Beside the spans, each :class:`.serving.engine.Request` carries two
stamps on the host's clock (``time.perf_counter``): ``t_submit`` and
``t_prefill``, where its prefill began; their difference is the time it
waited in the queue; and each :class:`.serving.engine.Engine` counts its
decode steps by action, ``graph_replays``, ``graph_captures`` and
``eager_decodes``, which add up to ``decode_steps``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_EVENT = torch._C._profiler._RecordFunctionFast


def recording() -> bool:
    """Is a profiler recording (the flag :func:`span` checks)?"""
    return _profiler._is_profiler_enabled


def span(name: str, args: dict | None = None):
    """A context that records ``name`` (with ``args``) as a profiler event
    while a profiler records, and the shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if args is None:
        return _EVENT(name)
    return _EVENT(name, (), args)

