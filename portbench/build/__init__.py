"""The program's side of each architecture: ``build/<model_type>.py``,
found by the configuration's ``model_type`` beside ``archs/<model_type>.py``.
Each gives

- ``model_config(config)``: the port's config object of a configuration
  file (bf16 activations);
- ``layer(config, layer, packed, dense, ones)``: the port's tree of one
  decoder layer from its packed quantized leaves and dense bf16 leaves
  (by the names ``archs/`` drew them under), with norms cloned from
  ``ones``, fused as the port fuses it;
- ``ffn(layer, cfg, h)``: the port's feed-forward of one such layer,
  which the CPU tests hold against the reference's.

Only the program's set-up and the tests import these."""
from __future__ import annotations

from types import ModuleType

from ..formats import load_named


def load(model_type: str) -> ModuleType:
    """The program's module of the architecture ``model_type``."""
    return load_named(__name__, model_type, "model_type")


def of(config: dict) -> ModuleType:
    """The program's module of a configuration file's ``model_type``."""
    return load(config.get("model_type") or "")
