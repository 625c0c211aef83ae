"""Gradient refinement of any4 LUTs (counterpart of ``any4_tpu/quant/nnq.py``;
the reference's nnq / ``learn_anyq``).

Each row's 16 LUT values (in the group-normalized ``[0, 15]`` domain) are
trained with Adam against a weight or layer-output objective. Every step
reassigns each weight to its nearest LUT value under ``torch.no_grad()``,
so the assignment is a constant of the gradient, which flows through the
reconstruction ``(lut[code] - 8) * scale + zero`` alone. ``torch.optim.Adam``
takes the place of ``optax.adam`` (the same update, other rounding), so the
port is held to JAX's by the loss it reaches, not by bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.quant import group_codes_float

OBJECTIVES = ("w_mse", "y_mse", "w_cossim", "y_cossim")


def _assign(wg: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Nearest-value assignment ``[n, k]`` for per-row LUTs ``[n, 16]``; the
    lower code on ties."""
    return torch.argmin((wg[:, :, None] - lut[:, None, :]).abs(), dim=2)


def _reconstruct(lut, assign, scales, zeros, group_size, n_bit=4):
    vals = torch.gather(lut, 1, assign) - 2 ** (n_bit - 1)
    n, k = assign.shape
    vg = vals.reshape(n, k // group_size, group_size)
    return (vg * scales[..., None] + zeros[..., None]).reshape(n, k)


def nlc_loss(output: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Negative log of the mean per-row cosine similarity (the reference's
    ``nlc_loss``)."""
    num = (output * label).sum(dim=-1)
    den = torch.linalg.norm(output, dim=-1) * \
        torch.linalg.norm(label, dim=-1) + 1e-8
    cos = torch.abs(torch.mean(num / den))
    return -torch.log(torch.clamp(cos, min=1e-8))


def loss(objective: str, wq: torch.Tensor, w: torch.Tensor,
         x: Optional[torch.Tensor]) -> torch.Tensor:
    """The objective of a reconstruction ``wq`` of ``w``; the ``y_*``
    objectives compare ``x @ wq.T`` with ``x @ w.T``."""
    if objective == "w_mse":
        return torch.mean((wq - w) ** 2)
    if objective == "w_cossim":
        return nlc_loss(wq, w)
    y, yq = x @ w.t(), x @ wq.t()
    if objective == "y_cossim":
        return nlc_loss(yq.t(), y.t())      # per output channel
    return torch.mean((y - yq) ** 2)


def learn_lut(w: torch.Tensor, lut_init: torch.Tensor, scales: torch.Tensor,
              zeros: torch.Tensor, group_size: int = 128,
              objective: str = "y_mse",
              sample_activations: Optional[torch.Tensor] = None,
              steps: int = 200, lr: float = 1e-3, seed: int = 0):
    """Refine per-row LUTs ``[n, 16]`` of ``w`` ``[n, k]`` on ``w``'s device.

    ``objective`` is one of :data:`OBJECTIVES` (the reference's W_mse,
    Y_mse and cosine criteria). ``sample_activations`` ``[t, k]`` drive the
    ``y_*`` objectives; without them 256 rows of standard normal
    activations are drawn from a ``torch.Generator`` seeded with ``seed``
    (other numbers than ``jax.random``'s). Returns ``(lut f32 [n, 16]``
    sorted ascending, ``codes uint8 [n, k])``, the codes reassigned to the
    sorted LUT.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}, got "
                         f"{objective!r}")
    w = w.float()
    dev = w.device
    wg, _, _ = group_codes_float(w, 4, group_size)
    scales = torch.as_tensor(scales, dtype=torch.float32, device=dev)
    zeros = torch.as_tensor(zeros, dtype=torch.float32, device=dev)
    x = None
    if objective.startswith("y_"):
        if sample_activations is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn((256, w.shape[1]), generator=gen, device=dev)
        else:
            x = torch.as_tensor(sample_activations, dtype=torch.float32,
                                device=dev)
    lut = torch.as_tensor(lut_init, dtype=torch.float32,
                          device=dev).detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([lut], lr=lr)
    with torch.enable_grad():
        for _ in range(steps):
            with torch.no_grad():
                assign = _assign(wg, lut)
            opt.zero_grad(set_to_none=True)
            loss(objective, _reconstruct(lut, assign, scales, zeros,
                                         group_size), w, x).backward()
            opt.step()
    lut = torch.sort(lut.detach(), dim=1).values
    return lut, _assign(wg, lut).to(torch.uint8)
