"""The port's halo exchange, halo multigrid CG and sharded grid solver on
Gloo CPU ranks against the JAX package.

One job of 4 rank processes (``parallel.dryrun.RankProcesses``, with a
time limit) runs every case on three meshes, (dp, sp) = (2, 2), (1, 4)
and (4, 1), and writes each rank's block; meanwhile this process computes
the JAX package's results: its stencil and transfers on one device, its
``make_halo_grid_solver`` on a JAX mesh with the same sp (dp = 1), its
``make_sharded_grid_solver`` on the (2, 4) mesh of ``tests/test_parallel``.

Tolerances, in f64 throughout: the halo stencil and transfers against the
single-device functions rtol 1e-12, atol 1e-12 (``tests/test_parallel.py``
:157, :210); the halo solvers within 1e-10 of max|x| with equal CG
iterations and residuals under 1e-9 at tol 1e-10 (the sums run in another
order than XLA's, so not bit for bit); the sharded grid solver within
1e-10 of max|x| and residuals under 1e-9.  ``cg(group=...)`` must run the
same iterations and loop passes on every rank of its group, and a
one-rank group must give the single-process loop's bits.
"""

import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from nodal_tpu.ops import grid as jgrid  # noqa: E402
from nodal_tpu.parallel import halo as jhalo  # noqa: E402
from nodal_tpu.parallel import mesh as jmesh  # noqa: E402
from nodal_tpu.parallel import sharded as jsharded  # noqa: E402
from nodal_tpu_torch.parallel.dryrun import RankProcesses  # noqa: E402

NPROC = 4
SPS = (2, 4, 1)
WORLD_SECONDS = 300     # the ranks' time limit, collectives' 120 s


def _rhs(B, h, w, seed):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((B, h, w))
    return b - b.mean(axis=(1, 2), keepdims=True)


# Solver cases: (kind, h, B, seed, mg) with the seeds of tests/test_parallel.
SOLVES = {"halo16": ("halo", 16, 4, 7, False),
          "halo128": ("halo", 128, 4, 5, True),
          "grid32": ("grid", 32, 4, 0, True),
          "grid128": ("grid", 128, 4, 11, True)}
TOL = 1e-10

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
from nodal_tpu_torch.ops.cg import cg
from nodal_tpu_torch.ops.grid import grid_operator
from nodal_tpu_torch.parallel import halo
from nodal_tpu_torch.parallel.mesh import grid_block, make_mesh
from nodal_tpu_torch.parallel.sharded import make_sharded_grid_solver
with open(f"{work}/cases.pkl", "rb") as f:
    c = pickle.load(f)
out = {}
for sp in sps:
    mesh = make_mesh(device="cpu", sp=sp)
    spg, dpg = mesh.get_group("sp"), mesh.get_group("dp")
    def block(x):  # every sample, this rank's rows
        _, rows = grid_block(mesh.size(0), x.shape[1], mesh)
        return torch.as_tensor(x[:, rows]).contiguous(), rows.start
    x, r0 = block(c["x16"])
    out[(sp, "matvec")] = (halo.halo_laplacian_matvec(x, spg).numpy(), r0)
    x, r0 = block(c["x32"])
    out[(sp, "restrict")] = (halo.halo_restrict_bilinear(x, spg).numpy(),
                             r0 // 2)
    x, r0 = block(c["xc16"])
    out[(sp, "prolong")] = (halo.halo_prolong_bilinear(x, spg).numpy(),
                            2 * r0)
    for name, (kind, h, B, mg) in c["solves"].items():
        samples, rows = grid_block(B, h, mesh)
        if kind == "halo":
            solver = halo.make_halo_grid_solver(
                h, h, mesh, dtype=torch.float64, tol=c["tol"], mg=mg,
                device="cpu")
            xb, res, its = solver(c[name])
            its = its.numpy()
        else:
            solver = make_sharded_grid_solver(
                h, h, mesh, dtype=torch.float64, tol=c["tol"], mg=mg,
                device="cpu")
            (xb, res), its = solver(c[name]), None
        out[(sp, name)] = {"x": xb.numpy(), "res": res.numpy(), "its": its,
                           "samples": (samples.start, samples.stop),
                           "rows": (rows.start, rows.stop)}
    # cg over the sp group: count this rank's loop passes (matvecs).
    b, _ = block(c["halo16"])
    n_total, calls = b.shape[1] * b.shape[2] * sp, [0]
    def matvec(v):
        calls[0] += 1
        s = v.sum(dim=(1, 2))
        dist.all_reduce(s, group=spg)
        return halo.halo_laplacian_matvec(v, spg) + (s / n_total)[:, None, None]
    _, info = cg(matvec, b, tol=c["tol"], maxiter=400, group=spg)
    out[(sp, "cg")] = (info.iterations.numpy(), calls[0])
    if mesh.size(0) == 1:  # a one-rank dp group: the single-process bits
        full = torch.as_tensor(c["halo16"])
        xg, ig = cg(grid_operator, full, tol=c["tol"], group=dpg)
        xs, is_ = cg(grid_operator, full, tol=c["tol"])
        out[(sp, "one_rank_bits")] = bool(torch.equal(xg, xs)
                                          and torch.equal(ig.iterations,
                                                          is_.iterations))
dist.destroy_process_group()
assert "jax" not in sys.modules and "nodal_tpu" not in sys.modules
with open(f"{work}/out{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (see test_torch_grid)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_references(c):
    rows = lambda f, xs: np.stack([np.asarray(f(jnp.asarray(x)))  # noqa
                                   for x in xs])
    refs = {"matvec": rows(jgrid.laplacian_matvec, c["x16"]),
            "restrict": rows(jgrid._restrict_bilinear, c["x32"]),
            "prolong": rows(jgrid._prolong_bilinear, c["xc16"])}
    grid_mesh = jmesh.make_mesh(8)
    for name, (kind, h, B, seed, mg) in SOLVES.items():
        rhs = jnp.asarray(c[name])
        if kind == "grid":
            x, res = jsharded.make_sharded_grid_solver(
                h, h, grid_mesh, dtype=jnp.float64, tol=TOL, mg=mg)(rhs)
            refs[name] = (np.asarray(x), np.asarray(res), None)
            continue
        for sp in SPS:
            x, res, its = jhalo.make_halo_grid_solver(
                h, h, jmesh.make_mesh(sp, sp=sp), dtype=jnp.float64,
                tol=TOL, mg=mg)(rhs)
            refs[(sp, name)] = (np.asarray(x), np.asarray(res),
                                np.asarray(its))
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results by (sp, case) and rank, the cases and the JAX
    results."""
    work = tmp_path_factory.mktemp("sharded_grid")
    rng = np.random.default_rng(1)
    c = {"x16": rng.standard_normal((2, 16, 16)),
         "x32": np.random.default_rng(2).standard_normal((2, 32, 32)),
         "xc16": np.random.default_rng(2).standard_normal((2, 16, 16)),
         "tol": TOL,
         "solves": {k: (kind, h, B, mg)
                    for k, (kind, h, B, _, mg) in SOLVES.items()}}
    for name, (_, h, B, seed, _) in SOLVES.items():
        c[name] = _rhs(B, h, h, seed)
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(c, f)
    command = [sys.executable, "-c", _RANK, str(work),
               ",".join(map(str, SPS))]
    with RankProcesses(command, NPROC, work,
                       timeout=WORLD_SECONDS) as ranks:
        refs = _jax_references(c)
        ranks.wait()
    outs = []
    for r in range(NPROC):
        with open(work / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs, c, refs


def _assemble(outs, key, full_shape):
    """The whole field from the ranks' (block, first row) pairs; ranks of
    one sp position over other dp groups must agree bit for bit."""
    got = np.full(full_shape, np.nan)
    for o in outs:
        blk, r0 = o[(key[0], key[1])]
        sl = got[:, r0:r0 + blk.shape[1]]
        assert np.isnan(sl).all() or np.array_equal(sl, blk)
        got[:, r0:r0 + blk.shape[1]] = blk
    assert not np.isnan(got).any()
    return got


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("what", ["matvec", "restrict", "prolong"])
def test_halo_stencil_and_transfers_match_reference(world, what, sp):
    outs, c, refs = world
    ref = refs[what]
    got = _assemble(outs, (sp, what), ref.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def _solution(outs, sp, name, B, h):
    """The whole batch [B, h, h] and the per-sample residuals and
    iterations, from every rank's block."""
    x = np.full((B, h, h), np.nan)
    res, its = np.full(B, np.nan), np.full(B, -1)
    for o in outs:
        rec = o[(sp, name)]
        s, r = slice(*rec["samples"]), slice(*rec["rows"])
        x[s, r] = rec["x"]
        for dst, src in ((res, rec["res"]), (its, rec["its"])):
            if src is None:
                continue
            # every sp rank of a dp group holds the same residuals
            assert (dst[s] == src).all() or (dst[s] < 0).all() \
                or np.isnan(dst[s]).all()
            dst[s] = src
    assert not np.isnan(x).any()
    return x, res, its


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("name", list(SOLVES))
def test_grid_solvers_match_reference(world, name, sp):
    outs, c, refs = world
    kind, h, B, _, _ = SOLVES[name]
    x, res, its = _solution(outs, sp, name, B, h)
    x_ref, res_ref, its_ref = refs[(sp, name) if kind == "halo" else name]
    assert (res < 1e-9).all(), res
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    if kind == "halo":
        np.testing.assert_array_equal(its, its_ref)


@pytest.mark.parametrize("sp", SPS)
def test_cg_group_agrees_on_every_rank(world, sp):
    outs, c, refs = world
    its = [o[(sp, "cg")][0] for o in outs]
    calls = [o[(sp, "cg")][1] for o in outs]
    assert all(np.array_equal(i, its[0]) for i in its)
    assert len(set(calls)) == 1 and calls[0] == int(its[0].max()) + 1
    # the plain halo CG's iterations, which the JAX package's halo CG takes
    np.testing.assert_array_equal(its[0], refs[(sp, "halo16")][2])
    if sp == max(SPS):
        assert all(o[(sp, "one_rank_bits")] for o in outs)
