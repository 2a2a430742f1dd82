"""Multi-device execution on ``torch.distributed``: meshes, the multi-host
set-up, sharded batched solves and the sharded and halo-exchange grid CG.

Counterpart of ``nodal_tpu/parallel``.  A JAX program drives every device
of its host from one process; a torch job runs one process (rank) a device,
so each function here runs on every rank of the job, and each rank gets
back its own block of the result."""
