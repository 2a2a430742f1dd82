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
and adjoint); and the weighted grids and lattices (per-edge
conductances, batched and differentiable MG-CG on the weighted-stencil
kernels); and the multi-device paths (``nodal_tpu_torch.parallel``: meshes
and the multi-host set-up on ``torch.distributed``, NCCL on the card and
Gloo on the CPU, the sharded batch sweep over the kernel tiers, the
sharded and halo-exchange grid MG-CG).  Entry points run on the card
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

    import numpy as np
    from nodal_tpu_torch import weighted_equivalent_resistance
    rng = np.random.default_rng(0)     # 1024 fabrics of 64×64, one batch
    gx = rng.uniform(0.5, 2.0, (1024, 64, 63)).astype(np.float32)
    gy = rng.uniform(0.5, 2.0, (1024, 63, 64)).astype(np.float32)
    R, residual = weighted_equivalent_resistance(64, 64, gx, gy, (0, 0),
                                                 (63, 63), tol=1e-6)
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
from nodal_tpu_torch.ops.grid_weighted import (  # noqa: F401
    weighted_equivalent_resistance,
    weighted_grid_solve,
)
from nodal_tpu_torch.ops.grid_weighted3 import (  # noqa: F401
    weighted_equivalent_resistance_3d,
    weighted_lattice_solve,
)
