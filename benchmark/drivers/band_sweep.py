"""Driver of the batched parameter sweep on the block-band tier:
``BatchedSolver`` over a 3-D resistor lattice, a batch of perturbed
parameter vectors a call, driven as ``drivers/sweep.py`` drives the mesh.

Configuration keys: those of ``sweep`` (``tier``, ``refine``, ``sigma``,
``limits``), with ``circuit`` a lattice: ``kind`` ``lattice``, ``d``,
``h``, ``w``, ``source_amps`` (rows from ``reference/lattice.py``).
Traffic keys: those of ``sweep``.

A traced call is whole when its kernels of the port's library equal what
every library wrapper a band-tier call can reach counted: PCR and the
scalar band one kernel a launch, block Thomas its kernels
(``band_solve_multi.kernels``; where the wrapper lacks that count, its
host loops times ``launch_plan``'s kernels a loop at ``last_shape``).

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

from drivers.sweep import Driver as SweepDriver
from portbench.program import Reservoir, load_kernels
from reference import mna_torch
from reference.lattice import lattice_rows


class LatticeCheck:
    def __init__(self, rows, x, params, limit, device):
        self.rows, self.x, self.params = rows, x, params
        self.limit, self.device = limit, device
        self.answers = len(x)

    def compare(self):
        if not len(self.x):
            return [("max_rel_err", float("inf"), self.limit)]
        params = torch.as_tensor(self.params, device=self.device)
        ref = mna_torch.NodalTorch(self.rows).solve(params)
        err = mna_torch.rel_errors(
            torch.as_tensor(self.x, device=self.device), ref)
        worst = float(torch.nan_to_num(err, nan=float("inf")).max())
        return [("max_rel_err", worst, self.limit)]


class Driver(SweepDriver):
    def __init__(self, config, traffic, seed, device, control):
        import nodal_tpu_torch as port
        from nodal_tpu_torch.ops import block_thomas, pcr, sband

        self._wrappers = {"pcr": pcr.pcr_solve,
                          "sband": sband.sband_solve_multi,
                          "thomas": block_thomas.band_solve_multi}
        self._plan = block_thomas.launch_plan
        self._max_r = block_thomas.MAX_R
        self._counts_kernels = hasattr(block_thomas.band_solve_multi,
                                       "kernels")
        self.spans = load_kernels(device)
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        c = config["circuit"]
        if c["kind"] != "lattice":
            raise ValueError(f"the band sweep drives lattices, not "
                             f"{c['kind']!r}")
        self.rows = lattice_rows(c["d"], c["h"], c["w"], c["source_amps"])
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
        if self._counts_kernels:
            self._wrappers["thomas"].kernels = 0

    def counters(self) -> dict:
        counters = super().counters()
        thomas = self._wrappers["thomas"]
        shape = thomas.last_shape
        if self._counts_kernels:
            kernels = thomas.kernels
        elif counters["thomas"]:
            B, nb, kb, r = shape
            kernels = counters["thomas"] * self._plan(
                B, nb, kb, min(r, self._max_r), 4).launches
        else:
            kernels = 0
        return {**counters, "thomas_kernels": kernels, "thomas_shape": shape}

    def expected_library_kernels(self, counters) -> int:
        """PCR and the scalar band launch one kernel a counted call, block
        Thomas its counted kernels."""
        return (counters["pcr"] + counters["sband"]
                + counters["thomas_kernels"])

    def collect(self) -> LatticeCheck:
        """The kept calls' sampled rows and their parameters, on the host;
        drops the program's state."""
        check = super().collect()
        return LatticeCheck(check.rows, check.x, check.params, check.limit,
                            self.device)
