"""Properties of the port's CUDA kernels that only the card can show
(marked ``chip``; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package.  The card has no JAX,
so run it there without the suite's ``conftest.py``:

    python -m pytest --noconftest -m chip tests/test_torch_chip_kernels.py
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from nodal_tpu_torch import BatchedSolver, Circuit, Netlist  # noqa: E402
from nodal_tpu_torch.ops.band import band_plan  # noqa: E402
from nodal_tpu_torch.ops.block_thomas import (  # noqa: E402
    band_solve_multi, launch_plan)
from nodal_tpu_torch.ops.sband import sband_solve_multi  # noqa: E402
from nodal_tpu_torch.ops.scalar_band import sband_plan  # noqa: E402
from nodal_tpu_torch.utils import tracing  # noqa: E402
from nodal_tpu_torch.utils.gridgen import (  # noqa: E402
    grid_rows, weighted_lattice_rows)

pytestmark = pytest.mark.chip


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("tier", ["sband", "band"])
def test_band_kernels_leave_their_inputs(cuda, tier, dtype):
    """The contract layer assembles the band once a run and solves every
    defect pass on it, so neither band kernel may write its band or its
    right-hand sides; a second solve on them gives the same answer."""
    rows = list(grid_rows(25, 40, (0, 0), (24, 39)))
    stamps = Circuit(Netlist.from_rows(
        rows + [["src", "A", "1", "1", "g"]])).stamps
    plan, solve = {"sband": (sband_plan(stamps), sband_solve_multi),
                   "band": (band_plan(stamps), band_solve_multi)}[tier]
    gen = torch.Generator(device=cuda).manual_seed(21)
    base = torch.as_tensor(stamps.params, dtype=dtype, device=cuda)
    params = base * (1.0 + 0.05 * torch.randn(
        (64, len(base)), generator=gen, dtype=dtype, device=cuda))
    W, _ = plan.assemble(stamps, params)
    rhs = torch.randn((64, 3, stamps.n), generator=gen, dtype=dtype,
                      device=cuda)
    R = plan.rhs_to_band(rhs).transpose(1, 2).contiguous()
    W0, R0 = W.clone(), R.clone()
    launches = solve.launches
    x = solve(W, R)
    again = solve(W, R)
    torch.cuda.synchronize(cuda)
    assert solve.launches > launches
    assert torch.equal(W, W0)
    assert torch.equal(R, R0)
    assert torch.equal(again, x)


def test_thomas_kernels_counted_a_host_loop(cuda):
    """A ``band``-tier sweep call of the 20×10×10 lattice: the tracing
    counter ``thomas_kernels`` and ``band_solve_multi.kernels`` both add
    ``launch_plan``'s kernels for every host loop, and each block-Thomas
    solve is a device-timed ``thomas.solve`` span."""
    d, h, w = 20, 10, 10
    rows = list(weighted_lattice_rows(
        np.ones((d, h, w - 1)), np.ones((d, h - 1, w)),
        np.ones((d - 1, h, w)), (0, 0, 0), (d - 1, h - 1, w - 1)))
    circuit = Circuit(Netlist.from_rows(rows + [["src", "A", "1", "1",
                                                 "g"]]))
    solver = BatchedSolver(circuit, device=cuda)
    assert solver.method == "band"
    params = np.tile(circuit.stamps.params, (64, 1))
    solver(params)  # builds the library outside the counted call
    loops, kernels = band_solve_multi.launches, band_solve_multi.kernels
    tracing.enable()
    try:
        solver(params)
        (call,) = tracing.recent(1)
    finally:
        tracing.disable()
    loops = band_solve_multi.launches - loops
    per_loop = launch_plan(*band_solve_multi.last_shape, 4).launches
    assert band_solve_multi.last_shape == (64, 16, 128, 1)
    assert loops == 1 + call.counters["contract_passes"]
    assert call.counters["thomas_kernels"] == loops * per_loop == \
        band_solve_multi.kernels - kernels
    spans = call.find("thomas.solve")
    assert len(spans) == loops
    assert all(s.device_ms > 0 for s in spans)
