"""What the port's scripts share: ``k=v`` argument strings, the ``--cpu``
device choice and the ``--tiny``/``--model-dir`` model choice."""
from __future__ import annotations

import argparse

import torch

from ..models import llama, loader


def parse_kv_args(s):
    """Parse 'k=v,k2=v2' strings (the reference's simple_parse_args_string)."""
    if not s:
        return {}
    out = {}
    for part in s.split(","):
        k, _, v = part.partition("=")
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k.strip()] = v
    return out


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU through the kernels' plain versions "
                        "(default: the GPU)")


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-dir", help="local HF checkpoint directory")
    p.add_argument("--tiny", action="store_true",
                   help="a random-init tiny model (the default without "
                        "--model-dir)")


def device(args) -> str:
    """``"cpu"`` with ``--cpu``, else ``"cuda"``; raises when there is no
    GPU, rather than running on the CPU."""
    if args.cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --cpu to run on the CPU")
    return "cuda"


def device_name(dev: str) -> str:
    """What a result names as its device: the GPU's name, or ``"cpu"``."""
    return torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"


def model(args, dev: str, vocab: int, layers: int = 2):
    """``(cfg, params)`` on ``dev``: a tiny Llama (``vocab``, ``layers``)
    from ``init_params(seed=0)`` with ``--tiny`` or without
    ``--model-dir``, else the checkpoint through ``loader.load_model``."""
    if args.tiny or not args.model_dir:
        cfg = llama.LlamaConfig.tiny(vocab=vocab, layers=layers)
        return cfg, llama.init_params(cfg, seed=0, device=dev)
    return loader.load_model(args.model_dir, device=dev)


def random_ids(shape, vocab: int, dev: str, seed: int = 1) -> torch.Tensor:
    """Token ids ``[b, t]`` drawn from a ``torch.Generator`` on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, tuple(shape), generator=gen, device=dev,
                         dtype=torch.int32)


def tokenizer(model_dir):
    """The checkpoint's ``transformers`` tokenizer, or None where there is
    none (no model directory, no ``transformers``, no tokenizer files)."""
    if not model_dir:
        return None
    try:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(model_dir)
    except (ImportError, OSError, ValueError):
        return None
