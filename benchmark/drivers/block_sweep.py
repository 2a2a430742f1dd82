"""Driver of the batched parameter sweep on the block tier:
``BatchedSolver`` over an unbanded random resistor network, a batch of
perturbed parameter vectors a call, driven as ``drivers/sweep.py`` drives
the mesh.

Configuration keys: those of ``sweep`` (``tier``, which must be
``block``, ``refine``, ``sigma``, ``limits``), with ``circuit`` a random
network: ``kind`` ``randnet``, ``nodes``, ``edges``, ``tie_every``,
``source_amps``, ``seed`` (rows from ``reference/randnet.py``).  Traffic
keys: those of ``sweep``.

A traced call is whole when its kernels of the port's library equal PCR
and the scalar band, one kernel a counted call, plus the call's
blocked-LU kernels: the program's ``lu_kernels`` counter, read from its
call record (``nodal_tpu_torch.utils.tracing``).  Where the record has no
LU counters (a program older than them), the wrappers'
``lu_factor.launches`` and ``lu_solve_factored.launches`` stand in, times
the launches of one factorization (``factor_launches``) and of one solve
(4q − 2 for q panels, ``csrc/dense_tile.cuh:lu_solve``) at the solve's
``last_shape``.

The check: the sampled rows of the f64 solutions the program returned,
against the plain PyTorch reference (``reference/mna_torch.py``: dense
f64 solves, TF32 off) on the run's device, by ``max|x − x_ref| /
max|x_ref|`` per sample, the worst of them.  The control
(``--control 1``) is the program's own raw f32 tier (``refine=False``) in
its place.
"""

from __future__ import annotations

import time

import torch

from drivers.band_sweep import LatticeCheck
from drivers.sweep import Driver as SweepDriver
from portbench.program import Reservoir, load_kernels
from reference import mna_torch
from reference.randnet import randnet_rows

LU_COUNTERS = ("lu_kernels", "lu_factorizations", "lu_substitutions")


class Driver(SweepDriver):
    def __init__(self, config, traffic, seed, device, control):
        import nodal_tpu_torch as port
        from nodal_tpu_torch.ops import lu, pcr, sband

        if config["tier"] != "block":
            raise ValueError(f"the block sweep drives the block tier, not "
                             f"{config['tier']!r}")
        self._wrappers = {"pcr": pcr.pcr_solve,
                          "sband": sband.sband_solve_multi}
        self._lu = lu
        self.spans = load_kernels(device)
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        c = config["circuit"]
        if c["kind"] != "randnet":
            raise ValueError(f"the block sweep drives random networks, not "
                             f"{c['kind']!r}")
        self.rows = randnet_rows(c["nodes"], c["edges"], c["tie_every"],
                                 c["source_amps"], c["seed"])
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
        base = mna_torch.NodalTorch.values(self.rows).to(
            dtype=torch.float32, device=device)
        pool = torch.randn((int(traffic["pool"]), self.units, len(base)),
                           generator=gen, dtype=torch.float32, device=device)
        self.pool = pool.mul_(float(config["sigma"])).add_(1.0).mul_(base)
        self.kept = Reservoir(int(traffic["check_calls"]), seed)

    def reset_counters(self) -> None:
        super().reset_counters()
        self._lu.lu_factor.launches = 0
        self._lu.lu_solve_factored.launches = 0

    def _record(self) -> dict | None:
        """The newest call record's counters, or None."""
        try:
            from nodal_tpu_torch.utils import tracing
        except ImportError:
            return None
        calls = tracing.recent(1)
        return calls[0].counters if calls else None

    def counters(self) -> dict:
        counters = super().counters()
        solve = self._lu.lu_solve_factored
        shape = solve.last_shape
        record = self._record()
        if record is not None and "lu_factorizations" in record:
            lu = {k: record.get(k, 0) for k in LU_COUNTERS}
        else:
            f, s = self._lu.lu_factor.launches, solve.launches
            n = shape[1] if shape else 0
            lu = {"lu_kernels": (f * self._lu.factor_launches(n)
                                 + s * (4 * (n // self._lu.BLOCK) - 2)),
                  "lu_factorizations": f, "lu_substitutions": s}
        return {**counters, **lu, "lu_shape": shape}

    def expected_library_kernels(self, counters) -> int:
        """PCR and the scalar band launch one kernel a counted call, the
        blocked LU its counted kernels."""
        return counters["pcr"] + counters["sband"] + counters["lu_kernels"]

    def collect(self) -> LatticeCheck:
        """The kept calls' sampled rows and their parameters, on the host;
        drops the program's state.  The check is the lattice's: dense f64
        solves of the plain PyTorch reference on the run's device."""
        check = super().collect()
        return LatticeCheck(check.rows, check.x, check.params, check.limit,
                            self.device)
