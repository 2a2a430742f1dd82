"""nodal_tpu_torch — the nodal-analysis framework in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of ``nodal_tpu`` (JAX on a TPU), which stays beside it as the
reference.  This package imports neither ``jax`` nor ``nodal_tpu``: the
host-only modules it needs (constants, netlist, stamp compiler, grid
generators, the RCM ordering and the band plans) are copies.
Ported: the single solve (``Circuit.solve`` and ``Solution``, the band
route on the CUDA block-Thomas kernel, the dense route on the library's
LU), two-point equivalent resistance (``equiv``) and both command lines
(``python -m nodal_tpu_torch.solver_cli``, ``python -m
nodal_tpu_torch.equiv_cli``); the batched parameter sweeps through every
tier of ``BatchedSolver`` — netlist compile, stamp values, tridiagonal,
band and dense assembly, the CUDA PCR, scalar-band LDLᵀ, block-Thomas and
blocked-LU kernels, the schur tier's sub-branches, the library-LU
``dense`` tier and the exact-f64 contract layer of
``BatchedSolver(refine="auto")`` — with ``sweep``, ``monte_carlo`` and
``sensitivities`` on top; and the matrix-free grid solve
(multigrid-preconditioned CG, batched over injection fields) with the CUDA
multigrid stencil kernels; and the sparse backend (``Circuit(sparse=True)``,
``-s``: Jacobi- and AMG-CG, the host skyline LDLᵀ, the native parser,
multi-probe equivalent resistance, and for circuits with branch rows the
ideal-source reduction and the bordered elimination with its transpose
and adjoint).  The weighted grids and the multi-device paths are not
ported yet.  Entry points run on the card
(``device="cuda"``) unless given ``device="cpu"``.

    from nodal_tpu_torch import Circuit, Netlist, monte_carlo
    print(Circuit(Netlist("examples/1.6.1.csv")).solve())

    from nodal_tpu_torch.utils.gridgen import ladder_rows
    ladder = Circuit(Netlist.from_rows(ladder_rows(256)))
    out = monte_carlo(ladder, {f"rs{k}": 0.05 for k in range(256)},
                      n=10_000, seed=1)    # mean, std, max_residual

    from nodal_tpu_torch import grid_equivalent_resistance
    R, info = grid_equivalent_resistance(1024, 1024, (512, 512), (513, 514),
                                         tol=1e-6)   # 1M nodes, on the card
"""

__version__ = "0.1.0"

from nodal_tpu_torch.netlist import (  # noqa: F401
    Component,
    Netlist,
    NetlistError,
    UnconnectedCircuitError,
    build_opmodel,
    find_ground_node,
    is_connected,
)
from nodal_tpu_torch.circuit import Circuit, Solution  # noqa: F401
from nodal_tpu_torch.models.stamps import Quirks, compile_stamps  # noqa: F401
from nodal_tpu_torch.batch import (  # noqa: F401
    BatchedSolver,
    monte_carlo,
    sensitivities,
    sweep,
)
from nodal_tpu_torch.ops.grid import (  # noqa: F401
    grid_equivalent_resistance,
    grid_equivalent_resistance_many,
    grid_solve,
)
