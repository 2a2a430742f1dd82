"""One step of every sharded path on small shapes, on every rank of a job.

Counterpart of ``dryrun_multichip`` in the JAX package's entry module
(``__graft_entry__.py``).  Run it on N Gloo ranks of this host:

    python -m nodal_tpu_torch.parallel.dryrun --nproc 4 --device cpu

which starts the N ranks as processes of their own (:class:`RankProcesses`,
each with a time limit) and prints each rank's summary, or call
:func:`dryrun_multichip` on every rank of a job that is already set up
(``multihost.initialize``), as ``chip_smoke.py`` does with one NCCL rank
on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from nodal_tpu_torch.parallel.mesh import batch_rows, grid_block, make_mesh

#: The infinite grid's knight's-move resistance, which the 1024² probe's R
#: approaches (``__graft_entry__.py`` holds it within 5e-3 of 0.7732).
KNIGHT_R = 0.7732
KNIGHT_R_TOL = 5e-3


class RankProcesses:
    """``nproc`` processes of one job on this host, each running
    ``command`` with ``--init file://<workdir>/pg --rank r --nproc n``
    appended, its output and errors in ``workdir/rank<r>.out`` and
    ``.err``.  A context manager: whatever still runs when it exits is
    killed.  :meth:`wait` fails as soon as one rank fails, or at the time
    limit, with the tail of every rank's errors."""

    def __init__(self, command: list[str], nproc: int, workdir, *,
                 timeout: float):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        store = self.workdir / "pg"
        store.unlink(missing_ok=True)  # a stale store hangs the next job
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        root = str(Path(__file__).resolve().parents[2])
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p)}
        self.procs, self.files = [], []
        for r in range(nproc):
            out = open(self.workdir / f"rank{r}.out", "w")
            err = open(self.workdir / f"rank{r}.err", "w")
            self.files += [out, err]
            self.procs.append(subprocess.Popen(
                [*command, "--init", f"file://{store}", "--rank", str(r),
                 "--nproc", str(nproc)],
                stdout=out, stderr=err, env=env, cwd=self.workdir))

    def _tails(self) -> str:
        return "\n".join(
            f"--- rank {r} (exit {p.returncode}):\n"
            + (self.workdir / f"rank{r}.err").read_text()[-3000:]
            for r, p in enumerate(self.procs))

    def wait(self) -> list[str]:
        """Each rank's output, once every rank exited with 0."""
        while True:
            codes = [p.poll() for p in self.procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                self.kill()
                raise RuntimeError(f"rank {failed[0]} failed:\n"
                                   + self._tails())
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > self.deadline:
                self.kill()
                raise TimeoutError(f"the ranks ran past {self.timeout} s:\n"
                                   + self._tails())
            time.sleep(0.05)
        for f in self.files:
            f.flush()
        return [(self.workdir / f"rank{r}.out").read_text()
                for r in range(len(self.procs))]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.kill()
        for f in self.files:
            f.close()


def _finite(t: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{what}: non-finite values")


def _close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float,
           what: str) -> None:
    if not torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol):
        err = float((a.double() - b.double()).abs().max())
        raise AssertionError(f"{what}: max difference {err:.3e}")


def _params(stamps, batch: int) -> np.ndarray:
    return np.tile(stamps.params.astype(np.float32), (batch, 1))


def _block_grad(solve, pb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d sum(w · solve(p)) / dp for this rank's block, w [B/N, n]."""
    p = pb.detach().clone().requires_grad_()
    (w * solve(p)).sum().backward()
    return p.grad


def _grid_value(x: torch.Tensor, point, h: int, mesh) -> torch.Tensor:
    """x at a grid ``point`` of this rank's dp block's first sample, read
    from the sp rank that holds its row."""
    _, rows = grid_block(mesh.size(0), h, mesh)
    v = torch.zeros(1, dtype=x.dtype, device=x.device)
    if rows.start <= point[0] < rows.stop:
        v += x[0, point[0] - rows.start, point[1]]
    dist.all_reduce(v, group=mesh.get_group("sp"))
    return v[0]


def dryrun_multichip(n_devices: int, *, device="cuda") -> dict:
    """One step of each sharded path on a mesh over the job's
    ``n_devices`` ranks, on every rank: the ladder, the banded mesh (its
    scalar-band tier against the block-Thomas one), the gradient, the
    Schur mesh against the f64 oracle, the sharded grid, the halo CG, and
    the 1024² grid by the halo multigrid CG, whose iterations must not
    exceed ``grid_solve``'s and whose knight's-move R must lie within 5e-3
    of 0.7732.  Returns a summary of the steps."""
    from nodal_tpu_torch import BatchedSolver, Circuit, Netlist
    from nodal_tpu_torch.ops.grid import grid_solve
    from nodal_tpu_torch.parallel.halo import make_halo_grid_solver
    from nodal_tpu_torch.parallel.sharded import (make_sharded_batch_solver,
                                                  make_sharded_grid_solver)
    from nodal_tpu_torch.utils.gridgen import grid_rows, ladder_rows

    mesh = make_mesh(n_devices, device=device)
    dp, sp = mesh.size(0), mesh.size(1)
    dev = torch.device(mesh.device_type)
    B = 2 * dp * sp
    summary = {"mesh": [dp, sp]}

    # 1. The data-parallel sweep of the ladder over the whole mesh.
    ladder = Circuit(Netlist.from_rows(ladder_rows(16)))
    out = make_sharded_batch_solver(ladder.stamps, mesh)(
        _params(ladder.stamps, B))
    _finite(out, "ladder")
    if tuple(out.shape) != (2, ladder.stamps.n):
        raise AssertionError(f"ladder block {tuple(out.shape)}")

    # 1b, 1c. A mesh: its own tier (scalar band) against the block-Thomas
    # tier on the same rows.
    mesh_rows = list(grid_rows(6, 30, (0, 0), (5, 29)))
    mesh_rows.append(["src", "A", "1", "n1_1", "g"])
    band = Circuit(Netlist.from_rows(mesh_rows))
    band_solver = make_sharded_batch_solver(band.stamps, mesh)
    band_params = _params(band.stamps, B)
    out_band = band_solver(band_params)
    pinned = make_sharded_batch_solver(band.stamps, mesh, method="band")
    _close(pinned(band_params), out_band, 0.0, 5e-4,
           "mesh: block-Thomas tier against the scalar band")
    summary["mesh_tiers"] = [band_solver.tier, pinned.tier]

    # 1d. The adjoint through the sharded solve against BatchedSolver's on
    # the rank's rows.
    rows = batch_rows(B, mesh)
    pb = torch.as_tensor(band_params, device=dev)
    wts = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (B, band.stamps.n)).astype(np.float32), device=dev)[rows]
    g_sh = _block_grad(band_solver, pb, wts)[rows]
    local = BatchedSolver(band, dtype=torch.float32, refine=False,
                          device=dev)
    g_lo = _block_grad(local, pb[rows], wts)
    scale = float(g_lo.abs().max()) or 1.0
    _close(g_sh, g_lo, 5e-3, 2e-5 * scale, "mesh: sharded gradient")

    # 1e. The branch-equation (schur) tier, forward and adjoint, against
    # the f64 refined oracle.
    br_rows = list(grid_rows(10, 30, (0, 0), (9, 29)))
    br_rows.append(["e1", "E", "2", "1", "g"])
    br_rows.append(["d1", "VCCS", "0.5", "n3_3", "g", "1", "g"])
    branch = Circuit(Netlist.from_rows(br_rows))
    br_solver = make_sharded_batch_solver(branch.stamps, mesh)
    if br_solver.tier != "schur":
        raise AssertionError(f"branch mesh runs the {br_solver.tier} tier")
    br_params = torch.as_tensor(_params(branch.stamps, B), device=dev)
    oracle = BatchedSolver(branch, dtype=torch.float64, refine=True,
                           device=dev)
    out_or = oracle(br_params[rows])
    out_br = br_solver(br_params)
    br_err = float((out_br.double() - out_or).abs().max()
                   / out_or.abs().max())
    if br_err >= 5e-4:
        raise AssertionError(f"schur tier {br_err:.2e} from the f64 oracle")
    wb = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (B, branch.stamps.n)).astype(np.float32), device=dev)[rows]
    g_br = _block_grad(br_solver, br_params, wb)[rows]
    g_or = _block_grad(oracle._solve, br_params[rows].double(), wb.double())
    gsc = float(g_or.abs().max()) or 1.0
    _close(g_br, g_or, 5e-3, 5e-4 * gsc, "schur tier gradient")
    summary["schur_rel_err"] = br_err

    # 2, 3. The sharded grid solve and the plain halo CG.
    h = w = 16 if sp <= 4 else 4 * sp
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal((2 * dp, h, w)).astype(np.float32)
    rhs -= rhs.mean(axis=(1, 2), keepdims=True)
    xs, _ = make_sharded_grid_solver(h, w, mesh, tol=1e-4, maxiter=50,
                                     device=dev)(rhs)
    _finite(xs, "sharded grid")
    xs2, _, _ = make_halo_grid_solver(h, w, mesh, tol=1e-4, maxiter=200,
                                      mg=False, device=dev)(rhs)
    _finite(xs2, "halo CG")

    # 4. The 1024² grid by the halo multigrid CG, against grid_solve.
    H = W = 1024
    if H % (2 * sp) == 0:
        a, b = (H // 2, W // 2), (H // 2 + 1, W // 2 + 2)
        probe = torch.zeros(dp, H, W, device=dev)
        probe[:, a[0], a[1]] += 1.0
        probe[:, b[0], b[1]] -= 1.0
        x3, _, its = make_halo_grid_solver(H, W, mesh, tol=1e-5, maxiter=40,
                                           device=dev)(probe)
        _finite(x3, "halo multigrid")
        its = int(its.max())
        _, info = grid_solve(H, W, probe[0], tol=1e-5, maxiter=40,
                             device=dev)
        single = int(info.iterations)
        if its > single:
            raise AssertionError(f"halo multigrid took {its} CG iterations "
                                 f"on the 1024² grid, grid_solve {single}")
        R = float(_grid_value(x3, a, H, mesh) - _grid_value(x3, b, H, mesh))
        if abs(R - KNIGHT_R) >= KNIGHT_R_TOL:
            raise AssertionError(f"1024² knight's-move R = {R}")
        summary.update(halo_iterations=its, grid_solve_iterations=single,
                       R=R)
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks of the job (default 1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the ranks may take (default 600)")
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        command = [sys.executable, "-m", "nodal_tpu_torch.parallel.dryrun",
                   "--device", args.device, "--timeout", str(args.timeout)]
        with tempfile.TemporaryDirectory() as tmp, \
                RankProcesses(command, args.nproc, tmp,
                              timeout=args.timeout) as ranks:
            outs = ranks.wait()
        for out in outs:
            print(out.strip())
        print(f"dryrun_multichip({args.nproc}): ok")
        return

    from nodal_tpu_torch.parallel.multihost import initialize

    torch.set_num_threads(1)
    initialize(args.init, args.nproc, args.rank, device=args.device,
               timeout=timedelta(seconds=args.timeout))
    try:
        summary = dryrun_multichip(args.nproc, device=args.device)
    finally:
        dist.destroy_process_group()
    if "jax" in sys.modules or "nodal_tpu" in sys.modules:
        raise RuntimeError("the dry run imported jax or nodal_tpu")
    print(json.dumps({"rank": args.rank, **summary}))


if __name__ == "__main__":
    main()
