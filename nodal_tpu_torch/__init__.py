"""nodal_tpu_torch — the nodal-analysis framework in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of ``nodal_tpu`` (JAX on a TPU), which stays beside it as the
reference.  This package imports neither ``jax`` nor ``nodal_tpu``: the
host-only modules it needs (constants, netlist, stamp compiler, grid
generators, the RCM ordering and the band plans) are copies.
Ported so far: the batched parameter sweeps through every tier of
``BatchedSolver`` — netlist compile, stamp values, tridiagonal, band and
dense assembly, the CUDA PCR, scalar-band LDLᵀ, block-Thomas and blocked-LU
kernels, the schur tier's sub-branches, the library-LU ``dense`` tier and
the exact-f64 contract layer of ``BatchedSolver(refine="auto")``.

    from nodal_tpu_torch import BatchedSolver, Circuit, Netlist
    from nodal_tpu_torch.utils.gridgen import grid_rows
    rows = list(grid_rows(25, 40, (0, 0), (24, 39))) + [
        ["src", "A", "1", "1", "g"]]
    circuit = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(circuit, device="cuda")   # method "sband"
    xs = solver(params_batch)          # [B, n] float64 node voltages
"""

__version__ = "0.1.0"

from nodal_tpu_torch.netlist import (  # noqa: F401
    Netlist,
    NetlistError,
    UnconnectedCircuitError,
)
from nodal_tpu_torch.circuit import Circuit  # noqa: F401
from nodal_tpu_torch.models.stamps import compile_stamps  # noqa: F401
from nodal_tpu_torch.batch import BatchedSolver  # noqa: F401
