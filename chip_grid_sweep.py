"""Blocks-per-SM sweep of the block-Thomas kernel on one NVIDIA GPU.

    python3 chip_grid_sweep.py

Times ``band_solve_multi`` (``nodal_tpu_torch/csrc/block_thomas.cu``) by
CUDA events at the shapes ``chip_smoke.py`` times and the main paths give
it, in f32 and f64, with the grid launched at 1, 2, 3 and 4 blocks an SM
(``ops/block_thomas.py:BLOCKS_PER_SM``, which ``launch_config`` reads).
Each setting is read twice, in the order 1, 2, 3, 4, 4, 3, 2, 1.  Prints
the card's name and power limit, one JSON line a shape and dtype, and the
setting that won each.  Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# (B, nb, kb, r): the chip_smoke.py timing shapes (lattice, 100×100 mesh,
# kb = 256 lattice), the widebranch schur shape, and two that separate the
# batch from the depth (the lattice depth at B = 256, the 100×100 depth at
# B = 512).
SHAPES = [(1024, 16, 128, 1), (256, 79, 128, 1), (256, 10, 256, 1),
          (1024, 32, 128, 3), (256, 16, 128, 1), (512, 79, 128, 1)]
SETTINGS = (1, 2, 3, 4)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_grid_sweep: FAILED: CUDA is not available",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from nodal_tpu_torch.ops import block_thomas

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(3)
    default = block_thomas.BLOCKS_PER_SM
    try:
        for B, nb, kb, r in SHAPES:
            for dtype in (torch.float32, torch.float64):
                W, R = chip_smoke.random_block_band(B, nb, kb, r, dtype, gen)
                want = block_thomas.band_solve_multi(W, R)
                ms = {k: [] for k in SETTINGS}
                grid = {}
                for k in SETTINGS + SETTINGS[::-1]:
                    block_thomas.BLOCKS_PER_SM = k
                    grid[k] = block_thomas.launch_config(
                        B, nb, kb, r, W.element_size(), sm_count).grid
                    got = block_thomas.band_solve_multi(W, R)
                    if not torch.equal(got, want):
                        print(f"chip_grid_sweep: FAILED: {k} blocks an SM "
                              f"changed the answer at {(B, nb, kb, r)}",
                              file=sys.stderr)
                        sys.exit(1)
                    ms[k].append(chip_smoke.cuda_ms(
                        lambda: block_thomas.band_solve_multi(W, R),
                        reps=5, warmup=1))
                block_thomas.BLOCKS_PER_SM = default
                best = min(SETTINGS, key=lambda k: min(ms[k]))
                print(json.dumps({
                    "B": B, "nb": nb, "kb": kb, "r": r, "dtype": str(dtype),
                    "ms": ms, "grid": grid,
                    "best_blocks_per_sm": best}), flush=True)
                del W, R, want, got
                torch.cuda.empty_cache()
    finally:
        block_thomas.BLOCKS_PER_SM = default


if __name__ == "__main__":
    main()
