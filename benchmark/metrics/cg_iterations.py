"""cg_iterations: CG iterations a traced call, from the SolveInfo the entry
returns (moves call_ms_p95.host)."""

from portbench.layers import cg_iterations as read  # noqa: F401
