"""torch_ops_ms.sweep: device ms a traced call spends in PyTorch kernels:
stamp values, assembly and the f64 contract layer (mesh1k.mc16k; moves
solves_per_s)."""

from portbench.layers import torch_ops_ms as read  # noqa: F401
