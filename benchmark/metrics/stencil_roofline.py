"""stencil_roofline: the multigrid stencil kernels' share of their
roofline, %, bound by bytes over 3.35 TB/s (moves call_ms_p95.host)."""

from portbench.layers import stencil_roofline as read  # noqa: F401
