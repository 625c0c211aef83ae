"""Activation calibration: per-linear mean input magnitudes (counterpart of
``any4_tpu/calibrate.py``).

A forward with a ``capture`` store records, for every linear, the sums of
its input over all tokens (:func:`~any4_tpu_torch.models.llama._capture`);
calibration is forward passes over a prompt and one division. The result
feeds any4's weighted k-means as ``sample_weight``
(``quantize_model(sample_weight=...)``, or per layer through
``quantize_model(calibrate_fn=make_calibrate_fn(...))``).
:func:`save_calibration` writes the JAX package's ``.npz`` layout, so
files cross between the packages either way.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .models import generate, llama
from .ops.quant import div

# A handwritten multi-domain calibration prompt (fiction, news, code, math,
# facts), the JAX package's text.
default_prompt = """Calibration passage spanning several domains.
Story: The lighthouse keeper climbed the spiral stairs at dusk, counting
each step while the storm gathered over the bay, and wondered whether the
supply boat would arrive before the lamp oil ran out.
News: Markets rallied on Tuesday after the central bank signalled a pause
in rate hikes; analysts cautioned that inflation data due Friday could
reverse the gains.
Code: def fib(n):\n    a, b = 0, 1\n    for _ in range(n):\n        a, b = b, a + b\n    return a
Math: (12.5 * 3.2 - 7.75) / 4.05 + 18 % 5 = approximately 9.9
Facts: Water boils at 100 degrees Celsius at sea level. Mount Everest rises
8,849 metres above sea level. The mitochondrion is the powerhouse of the
cell."""


def calibrate(
    params: Dict,
    cfg: "llama.LlamaConfig",
    input_ids,
    layers: Optional[List[str]] = None,
    use_abs: bool = True,
    batch_size: int = 1,
    forward_fn: Optional[Callable] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Run forward passes over ``input_ids`` ``[num_seqs, seq_len]``,
    ``batch_size`` sequences at a time, and return ``{linear_name: mean
    |input| [k]}`` (f32, on the params' device, which must be of
    ``device``'s type).

    ``layers`` keeps only the names listed (the per-layer online mode);
    ``use_abs=False`` averages the signed inputs. ``forward_fn`` defaults
    to :func:`.models.llama.forward` (pass ``mixtral.forward`` or
    ``opt.forward`` for those trees).
    """
    dev = generate._check_device(params, device)
    forward_fn = forward_fn or llama.forward
    input_ids = torch.as_tensor(input_ids, device=dev)
    totals: Dict[str, tuple] = {}
    for i in range(0, input_ids.shape[0], batch_size):
        store: Dict[str, tuple] = {}
        forward_fn(params, cfg, input_ids[i:i + batch_size], capture=store)
        for name, stats in store.items():
            if layers is not None and name not in layers:
                continue
            totals[name] = (tuple(a + b for a, b in zip(totals[name], stats))
                            if name in totals else stats)
    return {name: div(sa if use_abs else ss, c)
            for name, (sa, ss, c) in totals.items()}


def make_calibrate_fn(params, cfg, input_ids, **kwargs):
    """A callable for ``quantize_model(calibrate_fn=...)``: ``fn(layers,
    seed)`` runs :func:`calibrate` (with ``kwargs``) restricted to
    ``layers``, and returns the one tensor when one layer is asked for.
    ``seed`` is accepted and unused: calibration draws no random
    numbers."""

    def fn(layers: Optional[List[str]] = None, seed: int = 0):
        acts = calibrate(params, cfg, input_ids, layers=layers, **kwargs)
        if layers is not None and len(layers) == 1:
            return acts.get(layers[0])
        return acts

    return fn


def save_calibration(acts: Dict[str, torch.Tensor], path: str):
    """Write ``{name: [k]}`` as an ``.npz`` of f32 arrays."""
    np.savez(path, **{k: torch.as_tensor(v).detach().cpu().numpy()
                      for k, v in acts.items()})


def load_calibration(path: str) -> Dict[str, np.ndarray]:
    """Inverse of :func:`save_calibration` (numpy arrays, which
    ``quantize_model(sample_weight=...)`` takes)."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
