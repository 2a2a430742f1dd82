"""Multi-process (and multi-host) set-up of a ``torch.distributed`` job.

Counterpart of ``nodal_tpu/parallel/multihost.py``.  Every rank calls
:func:`initialize` once, before any collective, then builds meshes over
the whole job (:func:`global_mesh`).  On CUDA each rank drives one card
over NCCL; on the CPU the ranks talk over Gloo.  Launch with ``torchrun``
(no arguments: ``env://``) or give the coordinator, the world size and the
rank yourself.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from nodal_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT, make_mesh
from nodal_tpu_torch.utils.device import resolve_device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda",
               timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Initialize the default process group of this rank.

    ``coordinator_address`` is rank 0's ``host:port`` (TCP), or a whole
    init URL such as ``file:///shared/path``; ``num_processes`` is the
    world size and ``process_id`` this rank.  With no arguments the job
    comes from ``torchrun``'s variables (``env://``), the counterpart of
    JAX's cluster auto-detection.  ``device="cuda"`` selects the card
    ``LOCAL_RANK`` (else the rank modulo the cards of the host), then
    starts NCCL on it eagerly; ``"cpu"`` starts Gloo.  A collective that
    waits longer than ``timeout`` for a peer fails.
    """
    dev = resolve_device(device, "initialize")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = -1 if num_processes is None else int(num_processes)
    rank = -1 if process_id is None else int(process_id)
    if dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world, rank=rank, timeout=timeout)
        return
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = rank if rank >= 0 else int(os.environ.get("RANK", "0"))
    index = int(local) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    dist.init_process_group("nccl", init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout,
                            device_id=torch.device("cuda", index))


def global_mesh(sp: int | None = None, *, device="cuda"):
    """A (dp, sp) mesh spanning every rank of the job (all hosts)."""
    return make_mesh(None, sp, device=device)
