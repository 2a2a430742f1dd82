"""Device meshes over the ranks of a ``torch.distributed`` job.

Counterpart of ``nodal_tpu/parallel/mesh.py``, with its axis conventions:

* ``"dp"`` — data parallel: independent systems (Monte Carlo samples,
  parameter-sweep batches) split over ranks.
* ``"sp"`` — system parallel: the node axis of one large system (a grid's
  rows) split over ranks.

A JAX mesh holds the devices of one controller; here each rank is one
process driving one device, so a mesh covers the ranks of the default
process group, in rank order: rank ``i·sp + j`` sits at ``(i, j)``.  On
CUDA each rank owns one card and the group is NCCL (which refuses two
ranks on one card); on the CPU the group is Gloo.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nodal_tpu_torch.utils.device import resolve_device

#: How long a collective of the mesh's groups waits for a missing peer
#: before it fails: a rank that never arrives must not hang the job.
DEFAULT_TIMEOUT = timedelta(minutes=5)

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def mesh_shape(n: int, sp: int | None = None) -> tuple[int, int]:
    """``(dp, sp)`` of a mesh over ``n`` devices: ``sp`` defaults to the
    largest of 2 and 4 that divides ``n``, else 1."""
    if sp is None:
        sp = 1
        for cand in (2, 4):
            if n % cand == 0:
                sp = cand
    if n % sp:
        raise ValueError(f"sp={sp} does not divide device count {n}")
    return n // sp, sp


def make_mesh(n_devices: int | None = None, sp: int | None = None, *,
              device="cuda") -> DeviceMesh:
    """A (dp, sp) ``DeviceMesh`` over the ranks of the default group, with
    ``mesh_dim_names=("dp", "sp")``.

    Every rank must call it, in the same order as any other group
    creation.  ``n_devices`` must equal the world size (its default): each
    rank is one device.  ``device="cuda"`` needs CUDA and an NCCL default
    group, ``"cpu"`` a Gloo one.  The dp and sp groups are made here, each
    with ``DEFAULT_TIMEOUT``.
    """
    dev = resolve_device(device, "make_mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized;"
                           " call nodal_tpu_torch.parallel.multihost."
                           "initialize first")
    backend = dist.get_backend()
    if backend != _BACKENDS[dev.type]:
        raise ValueError(f"make_mesh(device={device!r}) needs a "
                         f"{_BACKENDS[dev.type]} default group, not "
                         f"{backend}")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked for, but the job "
                         f"has {world} ranks (one device a rank)")
    dp, sp = mesh_shape(n, sp)
    ranks = torch.arange(n).reshape(dp, sp)
    # Every rank creates every group, in one order: dp groups (columns of
    # the mesh), then sp groups (its rows).
    groups = []
    for dim_ranks in (ranks.T, ranks):
        mine = None
        for members in dim_ranks.tolist():
            g = dist.new_group(members, timeout=DEFAULT_TIMEOUT)
            if dist.get_rank() in members:
                mine = g
        groups.append(mine)
    return DeviceMesh.from_group(groups, dev.type, mesh=ranks,
                                 mesh_dim_names=("dp", "sp"))


def mesh_index(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's ``(i, j)`` on ``mesh``: its dp and sp coordinates."""
    i, j = mesh.get_coordinate()
    return int(i), int(j)


def batch_rows(batch: int, mesh: DeviceMesh) -> slice:
    """The rows of a global batch of ``batch`` samples that this rank's
    block holds: ``[r·B/N, (r+1)·B/N)``, r the rank's flat (dp, sp) index
    and N the mesh's size (the counterpart of a JAX array's
    ``addressable_shards`` under ``P(("dp", "sp"))``)."""
    n = mesh.size()
    if batch % n:
        raise ValueError(f"batch {batch} is not divisible by the mesh's "
                         f"{n} devices")
    i, j = mesh_index(mesh)
    r, per = i * mesh.size(1) + j, batch // n
    return slice(r * per, (r + 1) * per)


def grid_block(batch: int, h: int, mesh: DeviceMesh) -> tuple[slice, slice]:
    """The samples (over ``dp``) and grid rows (over ``sp``) of a global
    [B, H, W] grid batch that this rank's block holds (``P("dp", "sp",
    None)``)."""
    dp, sp = mesh.size(0), mesh.size(1)
    if batch % dp:
        raise ValueError(f"batch {batch} is not divisible by dp={dp}")
    if h % sp:
        raise ValueError(f"grid rows {h} not divisible by sp={sp}")
    i, j = mesh_index(mesh)
    per, hl = batch // dp, h // sp
    return slice(i * per, (i + 1) * per), slice(j * hl, (j + 1) * hl)
