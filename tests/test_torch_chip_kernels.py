"""Properties of the port's CUDA kernels that only the card can show
(marked ``chip``; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package.  The card has no JAX,
so run it there without the suite's ``conftest.py``:

    python -m pytest --noconftest -m chip tests/test_torch_chip_kernels.py
"""

import pytest

torch = pytest.importorskip("torch")

from nodal_tpu_torch import Circuit, Netlist  # noqa: E402
from nodal_tpu_torch.ops.band import band_plan  # noqa: E402
from nodal_tpu_torch.ops.block_thomas import band_solve_multi  # noqa: E402
from nodal_tpu_torch.ops.sband import sband_solve_multi  # noqa: E402
from nodal_tpu_torch.ops.scalar_band import sband_plan  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows  # noqa: E402

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
