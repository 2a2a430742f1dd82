"""Driver of the matrix-free grid solve: equivalent resistance between
two nodes of an h×w grid of equal resistors, one pair a call through the
port's public entry ``grid_equivalent_resistance``.

Configuration keys: ``h``, ``w``, ``resistance``, ``dtype``, ``tol``,
``limits``.  Traffic keys: ``offset`` (b = a + offset), ``pool``
(distinct pairs, drawn from the seed and cycled), ``region`` (the share
of each side, centred, that a is drawn from), ``warm_calls``,
``trace_calls``.

The check, over every call in the window: R against the plain
reference's exact modal sum (``reference/grid.py``), by
``|R − R_ref| / R_ref``, the worst of them; and the relative residual
that CG returned over the configuration's ``tol``, the worst of them,
which the configuration's guarantee holds at 1 (its limit there).  The control
(``--control 1``) puts the reference in the program's place with its
potential field held in bfloat16; it returns no residual.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.program import load_kernels, rng
from reference import grid as ref_grid


class GridCheck:
    def __init__(self, config, pairs, R, residual):
        self.config, self.pairs, self.R = config, pairs, R
        self.residual = residual
        self.answers = int(R.size)

    def compare(self):
        c = self.config
        cache, worst = {}, 0.0 if self.R.size else float("inf")
        for (a, b), r in zip(self.pairs, self.R):
            if (a, b) not in cache:
                cache[a, b] = ref_grid.resistance(c["h"], c["w"], a, b,
                                                  c["resistance"])
            err = abs(float(r) - cache[a, b]) / abs(cache[a, b])
            worst = max(worst, err if np.isfinite(err) else float("inf"))
        compared = [("max_rel_err", worst,
                     float(c["limits"]["max_rel_err"]))]
        if self.residual is not None:
            over = np.nan_to_num(self.residual / float(c["tol"]), nan=np.inf)
            compared.append(("max_residual_over_tol", float(over.max())
                             if over.size else float("inf"),
                             float(c["limits"]["max_residual_over_tol"])))
        return compared


class Driver:
    def __init__(self, config, traffic, seed, device, control):
        from nodal_tpu_torch.ops import grid, stencil

        self._grid, self._stencil = grid, stencil
        self.spans = load_kernels(device)
        self.config, self.traffic, self.device = config, traffic, device
        self.control = control
        h, w = int(config["h"]), int(config["w"])
        self.dtype = getattr(torch, config["dtype"])
        draw = rng(seed, 3)
        off = np.array(traffic["offset"])
        lo = (np.array([h, w]) * (1 - traffic["region"]) / 2).astype(int)
        hi = np.array([h, w]) - lo - off
        self.pool = []
        for _ in range(int(traffic["pool"])):
            a = tuple(int(v) for v in draw.integers(lo, hi))
            self.pool.append((a, (a[0] + int(off[0]), a[1] + int(off[1]))))
        self.units = 1
        if control:
            res = float(config["resistance"])
            self._control = [torch.tensor(
                [ref_grid.resistance_bf16(h, w, a, b, res)],
                dtype=self.dtype, device=device) for a, b in self.pool]
        self.kept = []
        self._iterations = None

    def warm(self):
        for k in range(int(self.traffic["warm_calls"])):
            self.call(k)

    def call(self, k: int):
        """(R, residual) of pair ``k`` of the pool, each of shape (1,),
        on the device; the residual is None under the control."""
        if self.control:
            return self._control[k % len(self.pool)].clone(), None
        a, b = self.pool[k % len(self.pool)]
        c = self.config
        R, info = self._grid.grid_equivalent_resistance(
            c["h"], c["w"], a, b, resistance=c["resistance"],
            dtype=self.dtype, tol=c["tol"], device=self.device)
        self._iterations = info.iterations
        return R.reshape(1), info.residual.reshape(1)

    def keep(self, k: int, out) -> None:
        self.kept.append((k, out))

    def reset_kept(self) -> None:
        self.kept = []

    _COUNTED = ("jacobi_sweeps", "presmooth_restrict", "prolong_postsmooth",
                "vcycle")

    def reset_counters(self) -> None:
        for name in self._COUNTED:
            getattr(self._stencil, name).launches = 0
        self._stencil.vcycle.cluster_launches = 0
        self._stencil.jacobi_sweeps.cluster_launches = 0
        self._iterations = None

    def counters(self) -> dict:
        st = self._stencil
        return {**{name: getattr(st, name).launches for name in self._COUNTED},
                "vcycle_cluster": st.vcycle.cluster_launches,
                "jacobi_cluster": st.jacobi_sweeps.cluster_launches}

    def expected_library_kernels(self, counters) -> int:
        """Every counted stencil launch is one kernel."""
        return sum(counters[name] for name in self._COUNTED)

    def describe(self, out, counters) -> dict:
        """The call's probe fields and its CG iterations (``SolveInfo``)."""
        its = self._iterations
        return {"fields": int(out[0].numel()),
                "iterations": None if its is None else int(its),
                "dtype": self.config["dtype"]}

    def collect(self) -> GridCheck:
        """R and the residual of every kept call, on the host; drops the
        program's state."""
        self.kept.sort(key=lambda kv: kv[0])
        pairs = [self.pool[k % len(self.pool)] for k, _ in self.kept]
        host = lambda ts: torch.cat(ts).to(torch.float64).cpu().numpy()
        R = host([out[0] for _, out in self.kept]) if self.kept \
            else np.zeros(0)
        res = None if self.control or not self.kept else \
            host([out[1] for _, out in self.kept])
        self.kept = []
        return GridCheck(self.config, pairs, R, res)
