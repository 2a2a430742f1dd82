"""The frozen bound arithmetic equals ``chip_smoke.py``'s at the smoke
log's shapes (in f64 where both are bound by bytes)."""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from roofline import bounds

DT = {"float32": torch.float32, "float64": torch.float64}


def same(ours: dict, theirs: dict) -> None:
    assert ours["bound_ms"] == pytest.approx(theirs["bound_ms"], rel=1e-12)
    assert ours["bound_by"] == theirs["bound_by"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sband_and_pcr(dtype):
    for B, n, w, r in chip_smoke.SBAND_TIME_SHAPES:
        W1 = w + 1
        theirs = chip_smoke.bound_ms(
            2.0 * n * (W1 * W1 + 2 * W1 * r) * B,
            n * (W1 + 2 * r) * B * torch.finfo(DT[dtype]).bits // 8,
            DT[dtype])
        same(bounds.sband_bound(B, n, W1, r, dtype), theirs)
    same(bounds.pcr_bound(1000, 16384, dtype),
         chip_smoke.pcr_bound(1000, 16384, DT[dtype]))
    assert bounds.sband_bound(16384, 999, 27, 1, "float32")["bound_ms"] == \
        pytest.approx(0.567, abs=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["jacobi_sweeps", "presmooth_restrict",
                                  "presmooth_restrict/x", "prolong_postsmooth",
                                  "prolong_postsmooth/x", "vcycle"])
def test_stencil(name, dtype):
    for B, h, w in chip_smoke.STENCIL_TIME_SHAPES + [(16, 1024, 1024)]:
        same(bounds.stencil_bound(name, B, h, w, dtype),
             chip_smoke.stencil_bound(name, B, h, w, DT[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_weighted_and_dense_counts(dtype):
    for shape in chip_smoke.WEIGHTED_SHAPES[:3]:
        for name in ("weighted_residual", "weighted_jacobi",
                     "weighted_jacobi_block"):
            same(bounds.weighted_bound(name, shape, dtype),
                 chip_smoke.weighted_bound(name, shape, DT[dtype]))
    assert bounds.block_thomas_flops(16, 128, 1) == \
        chip_smoke.block_thomas_flops(16, 128, 1)
    assert bounds.lu_flops(1024, 3) == chip_smoke.lu_flops(1024, 3)


def test_level_shapes_as_documented():
    from nodal_tpu_torch.ops.stencil import level_shapes

    for h, w in ((1024, 1024), (1022, 1022), (1000, 1000), (32, 32)):
        assert bounds.level_shapes(h, w) == level_shapes(h, w)
