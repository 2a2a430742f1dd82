"""host_syncs_per_iteration: the program's ``host_syncs`` counter over its
``cg.iteration`` spans in the traced calls (moves call_ms_p95.host)."""

from portbench.spans import host_syncs_per_iteration as read  # noqa: F401
