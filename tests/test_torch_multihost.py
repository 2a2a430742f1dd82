"""The port's multi-process set-up (``parallel/multihost.py``) and its dry
run, on Gloo CPU ranks.

A 2-process job over TCP, as ``tests/test_multihost.py`` runs the JAX
package's: ``initialize(coordinator_address=...)``, ``global_mesh()`` and
one sharded batch solve, each rank checking its own block against a numpy
dense solve (rtol 1e-8, atol 1e-12, the JAX test's); then
``python -m nodal_tpu_torch.parallel.dryrun --nproc 4 --device cpu``.
Every rank process has a time limit.
"""

import os
import socket
import subprocess
import sys

import pytest

from nodal_tpu_torch.parallel.dryrun import RankProcesses

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
from datetime import timedelta
import numpy as np
import torch
torch.set_num_threads(1)
coordinator = sys.argv[1]
a = sys.argv
rank, nproc = int(a[a.index("--rank") + 1]), int(a[a.index("--nproc") + 1])

from nodal_tpu_torch.parallel import multihost
from nodal_tpu_torch.parallel.mesh import make_mesh

multihost.initialize(coordinator_address=coordinator, num_processes=nproc,
                     process_id=rank, device="cpu",
                     timeout=timedelta(seconds=120))
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_rank() == rank
assert dist.get_backend() == "gloo"
mesh = multihost.global_mesh(device="cpu")
assert mesh.size() == 2 and tuple(mesh.shape) == (1, 2)
for bad in ({"n_devices": 3}, {"sp": 3}):
    try:
        make_mesh(device="cpu", **bad)
    except ValueError:
        pass
    else:
        raise AssertionError(f"make_mesh({bad}) did not raise")

from nodal_tpu_torch import Circuit, Netlist
from nodal_tpu_torch.ops.assemble import assemble_dense
from nodal_tpu_torch.parallel.mesh import batch_rows
from nodal_tpu_torch.parallel.sharded import make_sharded_batch_solver
from nodal_tpu_torch.utils.gridgen import ladder_rows

circuit = Circuit(Netlist.from_rows(ladder_rows(16)))
stamps = circuit.stamps
solver = make_sharded_batch_solver(stamps, mesh, dtype=torch.float64)
B = 8
rng = np.random.default_rng(0)
batch = stamps.params * (1.0 + 0.1 * rng.standard_normal(
    (B, len(stamps.params))))
xs = solver(batch).numpy()
rows = batch_rows(B, mesh)
assert xs.shape == (B // 2, stamps.n)
G, b = assemble_dense(stamps, torch.as_tensor(batch[rows]))
expected = np.linalg.solve(G.numpy(), b.numpy()[..., None])[..., 0]
np.testing.assert_allclose(xs, expected, rtol=1e-8, atol=1e-12)
dist.destroy_process_group()
assert "jax" not in sys.modules and "nodal_tpu" not in sys.modules
print(f"MULTIHOST_OK process={rank} rows={rows.start}:{rows.stop}",
      flush=True)
"""


def test_two_process_distributed_batch_solve(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    command = [sys.executable, "-c", _WORKER, f"127.0.0.1:{port}"]
    with RankProcesses(command, 2, tmp_path, timeout=240) as ranks:
        outs = ranks.wait()
    assert "MULTIHOST_OK process=0 rows=0:4" in outs[0]
    assert "MULTIHOST_OK process=1 rows=4:8" in outs[1]


def test_dryrun_multichip_on_four_cpu_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "nodal_tpu_torch.parallel.dryrun",
         "--nproc", "4", "--device", "cpu", "--timeout", "300"],
        cwd=_REPO, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip(4): ok" in proc.stdout
    assert proc.stdout.count('"R": 0.77') == 4
