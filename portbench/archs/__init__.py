"""Model architectures, one module a ``model_type``:
``archs/<model_type>.py``, found by the configuration's ``model_type`` as
a format is found by its name. Each is plain PyTorch and NumPy and
imports nothing of the port; the inputs, the reference and the per-layer
arithmetic read it. For layer ``layer`` of a configuration it gives:

- ``linears(config, layer)``: ``(name, n, k)`` of the quantized linears,
  in the order they are drawn;
- ``experts(config, layer)``: ``(prefix, E, K)`` when the linears whose
  names start with ``prefix`` are ``E`` routed experts, ``K`` of them a
  token, else None;
- ``draw_dense(config, layer, gen, device)``: the layer's dense bf16
  leaves (a router), drawn from the layer's generator after its linears;
- ``extra_flops(config, layer)``: a token's flops in those dense leaves;
- ``attention_flops(config, layer, ctx)``: QK and PV of one token over
  ``ctx`` positions;
- ``check(config)``, ``layer(ref, x, w, layer)`` and ``ffn(ref, h, w,
  layer)``: the reference's decoder layer and its feed-forward in float32
  (:class:`portbench.reference.model.Reference` passes itself as
  ``ref``), each returning its output and, for a routed layer, each
  position's router margin (how far its last chosen expert's logit lies
  above the first one left out), else None;
- ``tiny(config, f32=False)``: the sizes its CPU tests run at.

The program's side of the same architecture is ``build/<model_type>.py``.
A new architecture is these two new files; another name of one (``mistral``
for ``llama``) is a one-line file."""
from __future__ import annotations

from types import ModuleType

from ..formats import load_named


def load(model_type: str) -> ModuleType:
    """The module of the architecture ``model_type``."""
    return load_named(__name__, model_type, "model_type")


def of(config: dict) -> ModuleType:
    """The module of a configuration file's ``model_type``."""
    return load(config.get("model_type") or "")
