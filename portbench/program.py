"""The system under test, built from the drawn inputs: the port's kernels,
its config object and layers by the configuration's architecture
(``build/<model_type>.py``), its quantized leaves packed by the port
(``pack/<format>.py``), and the port's own projection fusion. The port is
imported here, in :mod:`.drive`, ``build/``, ``pack/`` and ``drivers/``,
and nowhere else in the harness.
"""
from __future__ import annotations

import time

import torch

from . import inputs


def model_config(config: dict):
    """The port's config object of a configuration file (bf16
    activations), by its architecture."""
    from . import build
    return build.of(config).model_config(config)


def build_kernels(device) -> float:
    """Seconds to build the port's CUDA libraries into its ``_build/``, all
    at once, or to find them built there (0 off the card)."""
    if torch.device(device).type != "cuda":
        return 0.0
    from any4_tpu_torch.ops import build
    t = time.perf_counter()
    build.build_all()
    return time.perf_counter() - t


def pack(config: dict, f):
    """The port's quantized leaf of one linear's drawn fields, by the
    configuration's format (``pack/<format>.py``)."""
    from . import pack as packing
    q = config["quantization"]
    return packing.load(q["format"]).pack(f, q["group_size"])


def build_params(config: dict, seed: int, device) -> dict:
    """The port's parameter tree of a configuration file, layer by layer:
    each layer's drawn fields are packed, then assembled and fused by the
    architecture's ``build/<model_type>.py`` before the next layer is
    drawn."""
    from . import build
    arch = build.of(config)
    d = inputs.hf(config, "hidden_size")
    ones = torch.ones(d, dtype=torch.bfloat16, device=device)
    params = dict(inputs.draw_dense(config, seed, device))
    params["norm"] = ones.clone()
    params["layers"] = []
    for li in range(inputs.hf(config, "num_hidden_layers")):
        fields, dense = inputs.draw_layer(config, seed, li, device)
        packed = {name: pack(config, f) for name, f in fields.items()}
        del fields
        params["layers"].append(arch.layer(config, li, packed, dense, ones))
        del packed, dense
    return params
