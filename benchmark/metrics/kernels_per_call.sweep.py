"""kernels_per_call.sweep: device kernels a traced call launches
(mesh1k.mc16k; moves solves_per_s)."""

from portbench.layers import kernels_per_call as read  # noqa: F401
