"""The least time the card could take for one block-Thomas solve, from the
shape alone: B block-tridiagonal systems of nb block rows of kb unknowns,
r right-hand sides.

Operations: ``bounds.block_thomas_flops`` a system, over the peak of the
unit the kernel's products run on (f32 on the CUDA cores, f64 on the FP64
tensor cores, as ``chip_smoke.py`` counts it).  Bytes: the band W
[B, nb, kb, 3kb] and the right-hand sides R [B, nb·kb, r] read once, the
solution X of R's shape written once.
"""

from __future__ import annotations

from roofline.bounds import ITEMSIZE, block_thomas_flops, bound_ms

PEAK = {"float32": "float32.cuda_core", "float64": "float64.tensor_core"}


def block_thomas_bound(B: int, nb: int, kb: int, r: int, dtype: str) -> dict:
    n = nb * kb
    return bound_ms(block_thomas_flops(nb, kb, r) * B,
                    n * (3 * kb + 2 * r) * B * ITEMSIZE[dtype], PEAK[dtype])
