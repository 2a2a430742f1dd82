"""Circuit: a netlist compiled to stamp tensors.

Counterpart of ``nodal_tpu/circuit.py`` for the batched path: the netlist
check, the stamp compilation and the memoized :meth:`Circuit.batched_solver`.
The single-solve surface (``Circuit.solve``, ``Solution``) is not ported yet.
"""

from __future__ import annotations

import torch

from nodal_tpu_torch.models.stamps import StampTensors, compile_stamps
from nodal_tpu_torch.netlist import Netlist


class Circuit:
    """A compiled circuit: netlist lowered to stamp tensors.

    Args:
        netlist: a finalized :class:`Netlist`.
    """

    def __init__(self, netlist: Netlist):
        if not isinstance(netlist, Netlist):
            raise TypeError("Input isn't a netlist")
        self.netlist = netlist
        self.stamps: StampTensors = compile_stamps(netlist)

    def batched_solver(self, *, dtype=torch.float32,
                       refine: bool | str = "auto", method: str = "auto",
                       device="cuda"):
        """Memoized :class:`~nodal_tpu_torch.batch.BatchedSolver` for this
        circuit, one per (dtype, refine, method, device)."""
        from nodal_tpu_torch.batch import BatchedSolver

        key = (dtype, refine, method, str(torch.device(device)))
        cache = self.__dict__.setdefault("_batched_solvers", {})
        if key not in cache:
            cache[key] = BatchedSolver(self, dtype=dtype, refine=refine,
                                       method=method, device=device)
        return cache[key]
