"""The least time the card could take for a kernel's work, from the
problem's shapes alone, so that the count does not move when the
implementation does.

Frozen copies of ``chip_smoke.py``'s ``bound_ms``, ``pcr_bound``,
``stencil_bound``, ``block_thomas_flops``, ``lu_flops`` and
``weighted_bound`` and of its scalar-band count (``time_sband``), with the
peak each divides by named: ``chip_smoke.py`` divides every f64 count by
the FP64 tensor cores' 67 TFLOP/s; the scalar band and the stencils run on
the CUDA cores, 34 TFLOP/s in f64.  Every count here is bound by bytes at
the benchmark's shapes, so the choice moves no share.  Each input byte is
counted read once and each output byte written once.
"""

from __future__ import annotations

from roofline.peaks import PEAK_BYTES, PEAK_FLOPS

ITEMSIZE = {"float32": 4, "float64": 8}


def cuda_core_peak(dtype: str) -> str:
    return f"{dtype}.cuda_core"


def bound_ms(flops: float, nbytes: float, peak: str) -> dict:
    """The larger of the operations over the named peak and the bytes over
    the memory rate, in ms, and which of the two bounds it."""
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "peak_flops": peak, "peak_bytes_per_s": PEAK_BYTES}


def sband_bound(B: int, n: int, W1: int, n_rhs: int, dtype: str) -> dict:
    """One scalar-band solve of B systems of n rows, W1 band slots and
    n_rhs right-hand sides: the band and the right-hand sides read, the
    solution written; 2·(W1² + 2·W1·n_rhs) flops a row."""
    return bound_ms(2.0 * n * (W1 * W1 + 2 * W1 * n_rhs) * B,
                    n * (W1 + 2 * n_rhs) * B * ITEMSIZE[dtype],
                    cuda_core_peak(dtype))


def pcr_bound(n: int, B: int, dtype: str) -> dict:
    """PCR: 5 values a row moved (4 bands read, x written), and the 8 flops
    a row of an O(n) tridiagonal solve (Thomas)."""
    return bound_ms(8.0 * n * B, 5 * n * B * ITEMSIZE[dtype],
                    cuda_core_peak(dtype))


STENCIL_SWEEPS = 8


def stencil_bound(name: str, B: int, h: int, w: int, dtype: str,
                  sweeps: int = STENCIL_SWEEPS) -> dict:
    """One stencil call on [B, h, w] fields: a sweep is 9 flops a cell, a
    restriction ~6 a fine cell, a prolongation 8; the V-cycle's bytes are
    its input and output.  The ``/x`` transfers also read the given x."""
    n = B * h * w
    values, flops = {
        "jacobi_sweeps": (3 * n, 9 * sweeps * n),
        "presmooth_restrict": (1.25 * n, 15 * n),
        "presmooth_restrict/x": (2.25 * n, 15 * n),
        "prolong_postsmooth": (2.25 * n, 17 * n),
        "prolong_postsmooth/x": (3.25 * n, 17 * n),
        "vcycle": (2 * n, 4 / 3 * 50 * n),
    }[name]
    return bound_ms(flops, values * ITEMSIZE[dtype], cuda_core_peak(dtype))


def block_thomas_flops(nb: int, kb: int, r: int) -> float:
    """Least flops of one block-Thomas solve with r right-hand sides: in
    every block row an LU of S (2/3·kb³) and S⁻¹·rhs (2·kb²·r); in every
    row but the first L·C and L·y (2·kb³ + 2·kb²·r); in every row but the
    last S⁻¹·U (2·kb³) and the backward C·x (2·kb²·r)."""
    return (nb * (2 / 3 * kb ** 3 + 2 * kb * kb * r)
            + (nb - 1) * (4 * kb ** 3 + 4 * kb * kb * r))


def lu_flops(n: int, r: int) -> float:
    """Least flops of one dense LU solve: the factorization (2/3·n³) and
    both sweeps (2·n²·r)."""
    return 2 / 3 * n ** 3 + 2 * n * n * r


def weighted_bound(name: str, shape, dtype: str, sweeps: int = 1) -> dict:
    """One weighted-stencil call on [B, d, h, w]: x, r and the conductances
    read once, one field written (the block kernel reads no x); a residual
    is 12 flops a node in a grid and 17 in a lattice, a sweep 18 and 26."""
    B, d, h, w = shape
    n = B * d * h * w
    g = B * (d * h * (w - 1) + d * (h - 1) * w + (d - 1) * h * w)
    lattice = d > 1
    if name == "weighted_residual":
        values, flops = 3 * n + g, (17 if lattice else 12) * n
    elif name == "weighted_jacobi":
        values, flops = 3 * n + g, (26 if lattice else 18) * n
    else:
        values, flops = 2 * n + g, (26 if lattice else 18) * n * sweeps
    return bound_ms(flops, values * ITEMSIZE[dtype], cuda_core_peak(dtype))


def level_shapes(h: int, w: int, coarsest: int = 8):
    """The grid multigrid's hierarchy as the program documents it: halve
    both dimensions while both are even and the smaller is above
    ``coarsest``."""
    shapes = [(h, w)]
    while min(h, w) > coarsest and h % 2 == 0 and w % 2 == 0:
        h, w = h // 2, w // 2
        shapes.append((h, w))
    return shapes
