"""Set-up steps that every driver of the port shares."""

from __future__ import annotations

import time

import numpy as np


def load_kernels(device: str) -> dict:
    """Load the port's CUDA kernel library, building it first with
    ``nvcc`` when this checkout has none for its sources (the first run of
    a checkout).  Returns the seconds it took and whether it built."""
    if device != "cuda":
        return {}
    from nodal_tpu_torch.utils import kernels

    built = not kernels.library_path().exists()
    t = time.perf_counter()
    kernels.load_library()
    return {"kernel_library_s": time.perf_counter() - t,
            "kernel_library_built": built}


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator of the run's seed, one stream a use."""
    return np.random.default_rng([seed % 2 ** 64, stream])


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from the
    seed (reservoir sampling): the calls whose answers are checked,
    whatever the number of calls in the window.  It holds references
    only, so keeping a device tensor copies nothing."""

    def __init__(self, size: int, seed: int):
        self.size, self.seed = size, seed
        self.clear()

    def clear(self) -> None:
        self.items, self.seen = [], 0
        self._rng = rng(self.seed, 1)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self._rng.integers(self.seen))
            if j < self.size:
                self.items[j] = item
