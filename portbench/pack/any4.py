"""any4 fields (:mod:`portbench.formats.any4`) as the port's
``QuantizedTensor``, packed by the port (``any4t`` at ``g % 128 == 0``)."""
from __future__ import annotations

import torch


def pack(f, g: int):
    from any4_tpu_torch.ops import linear as lin
    from any4_tpu_torch.ops import packing
    n, k = f.codes.shape
    scales, zeros = packing.pad_group_arrays(f.scales, f.zeros, k, g)
    fmt = "any4t" if g % 128 == 0 else "any4"
    return lin.QuantizedTensor(
        packing.pack_codes(f.codes), scales.t().contiguous(),
        zeros.t().contiguous(), f.lut.clone(), fmt, g, (n, k),
        torch.bfloat16)
