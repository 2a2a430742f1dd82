"""Driver of the batched parameter sweep: ``BatchedSolver`` over one
netlist topology, a batch of perturbed parameter vectors a call.

Configuration keys: ``circuit`` (rows, see ``reference/rows.py``),
``tier`` (the tier the program must choose), ``refine``, ``sigma`` (the
relative standard deviation of every component's normal perturbation),
``limits``.  Traffic keys: ``batch`` (samples a call), ``pool`` (distinct
parameter batches, made on the device from the seed and cycled),
``warm_calls``, ``trace_calls``, ``check_calls`` and ``check_rows`` (calls
drawn from the seed whose answers are checked, and rows of each).

The check: the sampled rows of the f64 solutions the program returned,
against the plain reference's sparse LU of the same parameters
(``reference/mna.py``), by ``max|x − x_ref| / max|x_ref|`` per sample,
the worst of them.  The control (``--control 1``) is the program's own
raw f32 tier (``refine=False``) in its place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.program import Reservoir, load_kernels, rng
from reference import mna
from reference.rows import rows_of


class SweepCheck:
    def __init__(self, rows, x, params, limit):
        self.rows, self.x, self.params, self.limit = rows, x, params, limit
        self.answers = len(x)

    def compare(self):
        ref = mna.ResistiveMNA(self.rows).solve(self.params)
        err = mna.rel_errors(self.x, ref)
        worst = float(np.nan_to_num(err, nan=np.inf).max()) \
            if len(err) else float("inf")
        return [("max_rel_err", worst, self.limit)]


class Driver:
    def __init__(self, config, traffic, seed, device, control):
        import nodal_tpu_torch as port
        from nodal_tpu_torch.ops import pcr, sband

        self._wrappers = {"pcr": pcr.pcr_solve,
                          "sband": sband.sband_solve_multi}
        self.spans = load_kernels(device)
        self.config, self.traffic, self.seed = config, traffic, seed
        self.rows = rows_of(config["circuit"])
        t = time.perf_counter()
        circuit = port.Circuit(port.Netlist.from_rows(self.rows))
        self.solver = port.BatchedSolver(
            circuit, dtype=torch.float32,
            refine=False if control else config["refine"], device=device)
        self.spans["compile_s"] = time.perf_counter() - t
        if self.solver.method != config["tier"]:
            raise RuntimeError(f"the program chose the {self.solver.method} "
                               f"tier, the configuration states "
                               f"{config['tier']}")
        slots = circuit.stamps.param_slot
        if [slots[row[0]] for row in self.rows] != list(range(len(self.rows))):
            raise RuntimeError("the program's parameter slots are not in row "
                               "order")

        self.units = int(traffic["batch"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed % 2 ** 63)
        base = torch.tensor(mna.ResistiveMNA(self.rows).values(self.rows),
                            dtype=torch.float32, device=device)
        pool = torch.randn((int(traffic["pool"]), self.units, len(base)),
                           generator=gen, dtype=torch.float32, device=device)
        self.pool = pool.mul_(float(config["sigma"])).add_(1.0).mul_(base)
        self.kept = Reservoir(int(traffic["check_calls"]), seed)

    def warm(self):
        for k in range(int(self.traffic["warm_calls"])):
            self.call(k)

    def call(self, k: int):
        return self.solver(self.pool[k % len(self.pool)])

    def keep(self, k: int, out) -> None:
        self.kept.offer((k, out))

    def reset_kept(self) -> None:
        self.kept.clear()

    def reset_counters(self) -> None:
        for w in self._wrappers.values():
            w.launches = 0

    def counters(self) -> dict:
        return {**{name: w.launches for name, w in self._wrappers.items()},
                "sband_shape": self._wrappers["sband"].last_shape}

    def expected_library_kernels(self, counters) -> int:
        """PCR and the scalar band launch one kernel a counted call."""
        return counters["pcr"] + counters["sband"]

    def describe(self, out, counters) -> dict:
        return {}

    def collect(self) -> SweepCheck:
        """The kept calls' sampled rows and their parameters, on the host;
        drops the program's state."""
        draw = rng(self.seed, 2)
        xs, ps = [], []
        for k, out in sorted(self.kept.items, key=lambda kv: kv[0]):
            rows = np.sort(draw.choice(out.shape[0], min(
                int(self.traffic["check_rows"]), out.shape[0]),
                replace=False))
            idx = torch.as_tensor(rows, device=out.device)
            xs.append(out[idx].to(torch.float64).cpu().numpy())
            ps.append(self.pool[k % len(self.pool)][idx]
                      .to(torch.float64).cpu().numpy())
        self.kept.clear()
        self.solver = self.pool = None
        return SweepCheck(self.rows,
                          np.concatenate(xs) if xs else np.zeros((0, 1)),
                          np.concatenate(ps) if ps else np.zeros((0, 1)),
                          float(self.config["limits"]["max_rel_err"]))
