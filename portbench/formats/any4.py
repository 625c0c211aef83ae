"""any4 at group size ``g``: for each linear ``[n, k]`` 4-bit codes
uniform over 0..15, a per-row 16-entry table (sorted normal draws times
:data:`LUT_SPREAD`, centered as any4 stores it), f32 group scales ``U(0.8,
1.2) / (LUT_SPREAD * sqrt(k))`` and f32 group zeros ``N(0, (0.05 /
sqrt(k))^2)``, so that ``lut[row, code] * scale + zero`` has about the
spread of ``N(0, 1/k)``, the port's ``init_params``. A layer's fields come
in four calls of its generator on the device. Plain PyTorch."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

LUT_SPREAD = 3.0


@dataclass
class Fields:
    """One linear's drawn fields: ``codes [n, k] uint8`` (0..15), ``lut
    [n, 16] f32`` (centered), ``scales``/``zeros [n, k/g] f32``."""
    codes: torch.Tensor
    lut: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor


def draw(gen: torch.Generator, linears: List[Tuple[str, int, int]], g: int,
         device) -> Dict[str, Fields]:
    """The fields of ``linears`` (``(name, n, k)``), in that order."""
    n_codes = sum(n * k for _, n, k in linears)
    n_rows = sum(n for _, n, _ in linears)
    n_groups = sum(n * (k // g) for _, n, k in linears)
    codes = torch.randint(0, 16, (n_codes,), dtype=torch.uint8,
                          generator=gen, device=device)
    luts = torch.randn((n_rows, 16), generator=gen, device=device)
    luts = torch.sort(luts, dim=1).values * LUT_SPREAD
    unit = torch.rand((n_groups,), generator=gen, device=device)
    zunit = torch.randn((n_groups,), generator=gen, device=device)
    out = {}
    c = r = q = 0
    for name, n, k in linears:
        ng = n * (k // g)
        out[name] = Fields(
            codes[c:c + n * k].view(n, k), luts[r:r + n],
            ((0.8 + 0.4 * unit[q:q + ng]) / (LUT_SPREAD * math.sqrt(k)))
            .view(n, k // g),
            (zunit[q:q + ng] * (0.05 / math.sqrt(k))).view(n, k // g))
        c, r, q = c + n * k, r + n, q + ng
    return out


def dequantize(f: Fields, g: int) -> torch.Tensor:
    """``lut[row, code] * scale + zero`` in f32, ``[n, k]``."""
    q = torch.gather(f.lut, 1, f.codes.long())
    s = torch.repeat_interleave(f.scales, g, dim=1)
    z = torch.repeat_interleave(f.zeros, g, dim=1)
    return q * s + z
