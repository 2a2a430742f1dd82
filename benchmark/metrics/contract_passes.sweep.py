"""contract_passes.sweep: defect passes of the contract layer a traced
call, the program's ``contract_passes`` counter (mesh1k.mc16k; moves
solves_per_s)."""

from portbench.spans import contract_passes as read  # noqa: F401
