"""issue_ms_per_iteration: mean host ms of the program's ``cg.iteration``
span, the time to issue one CG iteration's launches, in the traced calls
(moves call_ms_p95.host)."""

from portbench.spans import issue_ms_per_iteration as read  # noqa: F401
