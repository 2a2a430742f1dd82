"""contract_ms.sweep: device ms a traced call spends in the contract
layer's own work, from the program's spans: the self time of
``contract.run`` (f64 stamp values, COO apply, corrections, the rescue
check) less its ``tier.solve`` spans (mesh1k.mc16k; moves
solves_per_s)."""

from portbench.spans import contract_ms as read  # noqa: F401
