"""kernels_per_iteration: device kernels a traced call launches over its CG
iterations (moves call_ms_p95.host)."""

from portbench.layers import kernels_per_iteration as read  # noqa: F401
