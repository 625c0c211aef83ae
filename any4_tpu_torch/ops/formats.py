"""Fixed 4-bit codebooks (counterpart of ``any4_tpu/ops/formats.py``).

The port keeps its own copy of the tables so that it never imports the JAX
package:

- ``nf4``: the 16-entry NormalFloat table (bitsandbytes NF4);
- ``fp4``: the e2m1 table in sign-magnitude code order, scaled so that the
  largest magnitude is 1 (the bitsandbytes fp4 codebook);
- ``mx4``: the raw e2m1 values, the table of the ``mx4`` format (each group
  scaled by a power of two, its e8m0 exponent, :func:`.quant.mx4_quantize`).
"""
from __future__ import annotations

import numpy as np

NF4_TABLE = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)

# code = (sign << 3) | mag, mag 0..7 -> {0, .5, 1, 1.5, 2, 3, 4, 6};
# code 8 is -0.0
FP4_E2M1_TABLE = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0],
    dtype=np.float32,
)

FP4_BNB_TABLE = FP4_E2M1_TABLE / 6.0
FP4_E2M1_MAX = 6.0   # max_norm of fp4_e2m1
FP4_E2M1_EMAX = 2    # largest unbiased exponent of e2m1
E8M0_BIAS = 127      # shared-exponent bias for MX scale (e8m0)

_TABLES = {
    "nf4": NF4_TABLE,
    "fp4": FP4_BNB_TABLE,
    "mx4": FP4_E2M1_TABLE,
}


def get_table(name: str) -> np.ndarray:
    """Return the fixed 16-entry codebook for a named 4-bit format."""
    try:
        return _TABLES[name]
    except KeyError:
        raise ValueError(f"unknown fixed 4-bit format {name!r}; "
                         f"have {sorted(_TABLES)}") from None
