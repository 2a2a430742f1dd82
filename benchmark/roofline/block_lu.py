"""The least time the card could take for the blocked LU's work, from the
shape alone: B dense systems of n_pad unknowns (a multiple of 128), r
right-hand sides.

A factorization is bound by its operations, ``bounds.lu_flops(n, 0)``
(2/3·n³) a system, over the peak of the unit the kernel's products run on
(f32 on the CUDA cores, f64 on the FP64 tensor cores, as
``block_thomas.py`` counts them); its bytes are G read and written once.
A substitution on a kept factor is bound by its bytes: the factor read
once and the right-hand sides read and the solution written once, n_pad²
+ 2·n_pad·r values a system; its operations are both sweeps, 2·n²·r.  A
bound for whole solves would understate the share of a call that
factors once and substitutes twice.
"""

from __future__ import annotations

from roofline.bounds import ITEMSIZE, bound_ms, lu_flops

PEAK = {"float32": "float32.cuda_core", "float64": "float64.tensor_core"}


def lu_factor_bound(B: int, n: int, dtype: str) -> dict:
    return bound_ms(lu_flops(n, 0) * B, 2 * n * n * B * ITEMSIZE[dtype],
                    PEAK[dtype])


def lu_substitution_bound(B: int, n: int, r: int, dtype: str) -> dict:
    return bound_ms(2.0 * n * n * r * B,
                    (n * n + 2 * n * r) * B * ITEMSIZE[dtype], PEAK[dtype])
