"""The port's sharded batch solver on Gloo CPU ranks against the JAX
package on its virtual mesh.

One job of 4 rank processes (``parallel.dryrun.RankProcesses``, with a
time limit) runs every case on two meshes, (dp, sp) = (2, 2) and (1, 4),
and writes each rank's block; meanwhile this process computes the JAX
package's results, which do not depend on the mesh's shape.  The ranks
import torch, numpy and ``nodal_tpu_torch`` only, and get the JAX
package's stamps through ``stamps_from_reference``.  The blocks
concatenated in rank order must equal the global result.

Tolerances are the JAX tests' (``tests/test_parallel.py``): f64 solves
rtol 1e-8, atol 1e-12 against JAX's f64 solve; gradients rtol 1e-9, atol
1e-12; the Schur mesh in f32 within 2e-4 (forward) and 2e-3 (gradient)
of JAX's f64 oracle, relative to its largest value; f32 kernel tiers
within rtol 1e-4, atol 1e-4 of the JAX tier (:266), since the two run
different f32 arithmetic on meshes with κ·ε₃₂ near 1e-4; ``refine=True``
(three exact-COO f64 passes on both sides) within 1e-10 of max|x|.
"""

import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nodal_tpu import Circuit as JCircuit  # noqa: E402
from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu.batch import BatchedSolver as JBatchedSolver  # noqa: E402
from nodal_tpu.parallel import mesh as jmesh  # noqa: E402
from nodal_tpu.parallel import sharded as jsharded  # noqa: E402
from nodal_tpu.utils.gridgen import grid_rows, ladder_rows  # noqa: E402
from nodal_tpu_torch.models.stamps import stamps_from_reference  # noqa: E402
from nodal_tpu_torch.ops import cg as tcg  # noqa: E402
from nodal_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from nodal_tpu_torch.parallel import multihost  # noqa: E402
from nodal_tpu_torch.parallel.dryrun import RankProcesses  # noqa: E402

NPROC = 4
SPS = (2, 4)            # (dp, sp) = (2, 2) and (1, 4)
WORLD_SECONDS = 300     # the ranks' time limit, collectives' 120 s

# Each rank: every case on every mesh, its block (and gradient) to a file.
_RANK = r"""
import pickle, sys
from datetime import timedelta
import torch
import torch.distributed as dist
torch.set_num_threads(1)
work, sps = sys.argv[1], [int(s) for s in sys.argv[2].split(",")]
a = sys.argv
rank, nproc = int(a[a.index("--rank") + 1]), int(a[a.index("--nproc") + 1])
dist.init_process_group("gloo", init_method=a[a.index("--init") + 1],
                        world_size=nproc, rank=rank,
                        timeout=timedelta(seconds=120))
from nodal_tpu_torch.parallel.mesh import batch_rows, make_mesh
from nodal_tpu_torch.parallel.sharded import make_sharded_batch_solver
with open(f"{work}/cases.pkl", "rb") as f:
    cases = pickle.load(f)
out = {}
for sp in sps:
    mesh = make_mesh(device="cpu", sp=sp)
    for name, c in cases.items():
        solve = make_sharded_batch_solver(
            c["stamps"], mesh, dtype=c["dtype"], refine=c["refine"],
            pallas=c["pallas"], method=c["method"])
        p = torch.tensor(c["params"], requires_grad=True)
        x = solve(p)
        rows = batch_rows(len(c["params"]), mesh)
        rec = {"x": x.detach().numpy(), "tier": solve.tier,
               "rows": (rows.start, rows.stop)}
        if c["weights"] is not None:
            (torch.as_tensor(c["weights"])[rows] * x).sum().backward()
            rec["grad"] = p.grad[rows].numpy()
        out[(sp, name)] = rec
dist.destroy_process_group()
assert "jax" not in sys.modules and "nodal_tpu" not in sys.modules
with open(f"{work}/out{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
"""


def _mesh_rows(h, w, branch=False):
    rows = list(grid_rows(h, w, (0, 0), (h - 1, w - 1)))
    if branch:
        return rows + [["e1", "E", "2", "1", "g"],
                       ["d1", "VCCS", "0.5", "n3_3", "g", "1", "g"]]
    return rows + [["src", "A", "1", "n1_1", "g"]]


def _batch(jc, B, sigma, seed, dtype):
    rng = np.random.default_rng(seed)
    base = jc.stamps.params
    return (base * (1.0 + sigma * rng.standard_normal((B, len(base))))
            ).astype(dtype)


# name: (rows, B, sigma, seed, dtype, refine, pallas, method, tier, grad)
CASES = {
    "ladder16_f64": (ladder_rows(16), 16, 0.05, 3, "f64", False, "auto",
                     "auto", "tridiag", False),
    "mesh6x30_f64": (_mesh_rows(6, 30), 8, 0.05, 12, "f64", False, "auto",
                     "auto", "sband", False),
    "sband6x30_f32": (_mesh_rows(6, 30), 16, 0.05, 9, "f32", False, "on",
                      "auto", "sband", False),
    "band6x30_f32": (_mesh_rows(6, 30), 16, 0.05, 7, "f32", False, "on",
                     "band", "band", False),
    "tridiag64_f32": (ladder_rows(64), 8, 0.03, 11, "f32", False, "on",
                      "auto", "tridiag", False),
    "schur11x24_f32": (_mesh_rows(11, 24, branch=True), 8, 0.05, 0, "f32",
                       False, "on", "auto", "schur", True),
    "refine6x30": (_mesh_rows(6, 30), 8, 0.05, 4, "f64", True, "auto",
                   "auto", "dense", False),
    "grad9x30_f64": (_mesh_rows(9, 30), 16, 0.05, 5, "f64", False, "auto",
                     "auto", "sband", True),
}
_DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
           "f64": (np.float64, torch.float64, jnp.float64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (see test_torch_grid)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(name, B, n):
    if name.startswith("schur"):
        return np.ones((B, n), np.float32)  # the JAX test's sum(solve(p))
    return np.random.default_rng(5).standard_normal((B, n))


def _jax_reference(name, jc, params, weights):
    """(x, gradient or None) of the JAX package for one case: its sharded
    solver on a (2, 2) mesh of virtual devices, or for the Schur mesh its
    f64 refined oracle."""
    _, B, _, _, dt, refine, pallas, method, _, grad = CASES[name]
    if name.startswith("schur"):
        oracle = JBatchedSolver(jc, dtype=jnp.float64, refine=True)
        x = np.asarray(oracle(params.astype(np.float64)))
        g = jax.grad(lambda p: jnp.sum(oracle._solve(
            p.astype(jnp.float64))))(jnp.asarray(params))
        return x, np.asarray(g)
    solver = jsharded.make_sharded_batch_solver(
        jc.stamps, jmesh.make_mesh(NPROC, sp=2), dtype=_DTYPES[dt][2],
        refine=refine, pallas=pallas, method=method)
    x = np.asarray(solver(jnp.asarray(params)))
    if not grad:
        return x, None
    w = jnp.asarray(weights)
    g = jax.grad(lambda p: jnp.sum(w * solver(p)))(jnp.asarray(params))
    return x, np.asarray(g)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' blocks by (sp, case) and rank, and the JAX results."""
    work = tmp_path_factory.mktemp("sharded_batch")
    inputs, port_cases = {}, {}
    for name, (rows, B, sigma, seed, dt, refine, pallas, method, _,
               grad) in CASES.items():
        jc = JCircuit(JNetlist.from_rows(rows))
        params = _batch(jc, B, sigma, seed, _DTYPES[dt][0])
        weights = _weights(name, B, jc.stamps.n) if grad else None
        inputs[name] = (jc, params, weights)
        port_cases[name] = {
            "stamps": stamps_from_reference(jc.stamps), "params": params,
            "dtype": _DTYPES[dt][1], "refine": refine, "pallas": pallas,
            "method": method,
            "weights": None if weights is None else weights.astype(
                params.dtype)}
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(port_cases, f)
    command = [sys.executable, "-c", _RANK, str(work),
               ",".join(map(str, SPS))]
    with RankProcesses(command, NPROC, work,
                       timeout=WORLD_SECONDS) as ranks:
        refs = {name: _jax_reference(name, *inputs[name])
                for name in CASES}
        ranks.wait()
    blocks = []
    for r in range(NPROC):
        with open(work / f"out{r}.pkl", "rb") as f:
            blocks.append(pickle.load(f))
    return blocks, refs


@pytest.mark.parametrize("n,shape", [(8, (2, 4)), (4, (1, 4)), (2, (1, 2)),
                                     (1, (1, 1)), (6, (3, 2))])
def test_mesh_shape_matches_reference(n, shape):
    assert tmesh.mesh_shape(n) == shape
    if n in (8, 2, 1):   # tests/test_parallel.py's cases on JAX's mesh
        jshape = jmesh.make_mesh(n).shape
        assert (jshape["dp"], jshape["sp"]) == shape


def test_mesh_shape_rejects_sp_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.mesh_shape(4, sp=3)
    with pytest.raises(ValueError, match="does not divide"):
        jmesh.make_mesh(4, sp=3)


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.initialize("127.0.0.1:1", 1, 0, device="cuda")
    with pytest.raises(RuntimeError, match="not initialized"):
        tmesh.make_mesh(device="cpu")


def test_cg_without_group_makes_no_collective(monkeypatch):
    """``group=None`` adds no collective: the loop is the single-process
    one, bit for bit the same with ``group`` left out."""
    def refuse(*a, **k):
        raise AssertionError("a collective was called")

    monkeypatch.setattr(torch.distributed, "all_reduce", refuse)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 6))
    A = torch.as_tensor(A @ A.T + 6 * np.eye(6))
    b = torch.as_tensor(rng.standard_normal((3, 6)))
    x, info = tcg.cg(lambda v: v @ A, b, tol=1e-12)
    x2, info2 = tcg.cg(lambda v: v @ A, b, tol=1e-12, group=None)
    assert torch.equal(x, x2) and torch.equal(info.iterations,
                                              info2.iterations)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(
        A.numpy(), b.numpy().T).T, rtol=1e-10)


def _whole(blocks, key):
    """The ranks' blocks of one case in rank order, and their rows."""
    recs = [b[key] for b in blocks]
    return recs, [r["rows"] for r in recs]


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_batch_matches_reference(world, name, sp):
    blocks, refs = world
    rows_, B, *_, tier, grad = CASES[name]
    recs, spans = _whole(blocks, (sp, name))
    per = B // NPROC
    assert spans == [(r * per, (r + 1) * per) for r in range(NPROC)]
    assert all(r["tier"] == tier for r in recs)
    x = np.concatenate([r["x"] for r in recs])
    x_ref, g_ref = refs[name]
    assert x.shape == x_ref.shape
    if name.startswith("schur"):
        err = np.abs(x - x_ref).max() / np.abs(x_ref).max()
        assert err < 2e-4, err
        g = np.concatenate([r["grad"] for r in recs])
        gerr = np.abs(g - g_ref).max() / max(np.abs(g_ref).max(), 1.0)
        assert gerr < 2e-3, gerr
        return
    if name.startswith("refine"):
        assert x.dtype == np.float64
        assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    elif x.dtype == np.float32:
        np.testing.assert_allclose(x, x_ref, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-12)
    if grad:
        g = np.concatenate([r["grad"] for r in recs])
        np.testing.assert_allclose(g, g_ref, rtol=1e-9, atol=1e-12)


def test_sharded_batch_options_raise():
    from nodal_tpu_torch.parallel import sharded

    stamps = stamps_from_reference(
        JCircuit(JNetlist.from_rows(ladder_rows(4))).stamps)
    with pytest.raises(ValueError, match="pallas='off'"):
        sharded.make_sharded_batch_solver(stamps, None, pallas="off")
    with pytest.raises(ValueError, match="pallas must be"):
        sharded.make_sharded_batch_solver(stamps, None, pallas="yes")
    with pytest.raises(ValueError, match="unknown method"):
        sharded.local_tier(stamps, "fast")
    assert sharded.local_tier(stamps) == "tridiag"
    assert sharded.local_tier(stamps, refine=True) == "dense"
    assert sharded.local_tier(stamps, "sband") == "tridiag"  # JAX's fallback
