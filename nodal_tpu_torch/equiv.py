"""Two-point equivalent resistance of resistive networks.

Counterpart of ``nodal_tpu/equiv.py``'s single-pair functions.  Parity
target: reference equiv.py:22-61.  A 1 A probe current source goes in
between the two nodes, the circuit is solved, and the potential difference
is read off; the probe gets a fresh name (the reference hardcodes ``a1``
and clobbers a component of that name, quirk Q4).

For large uniform grids, prefer :mod:`nodal_tpu_torch.ops.grid`'s
matrix-free path, which never builds the netlist at all.
"""

from __future__ import annotations

import torch

from nodal_tpu_torch.batch import _adjoint_grad
from nodal_tpu_torch.circuit import Circuit
from nodal_tpu_torch.netlist import Netlist


def check_resistive(netlist: Netlist) -> bool:
    """True iff every component in the netlist is a resistor
    (reference equiv.py:22-28)."""
    return all(c.type == "R" for c in netlist.components.values())


def _probed(netlist: Netlist, a: str, b: str) -> Netlist:
    """The netlist with a 1 A probe source from ``a`` to ``b``, after the
    validation both functions share."""
    if not check_resistive(netlist):
        raise ValueError("Network is not resistive")
    for node in (a, b):
        if node not in netlist.nodenum and node != netlist.ground:
            raise KeyError(f"Node `{node}` not found in netlist")
    probe = netlist.fresh_name("a1")
    return netlist.with_component([probe, "A", "1", a, b])


def equivalent_resistance(
    netlist: Netlist, a: str, b: str, sparse: bool = False, *,
    dtype=torch.float64, device="cuda",
) -> float:
    """Equivalent resistance seen through nodes ``a`` and ``b``: one
    :meth:`Circuit.solve` on ``device``.

    Raises:
        ValueError: the netlist contains a non-resistor component.
        KeyError: either probe node is absent from the netlist.
    """
    probed = _probed(netlist, a, b)
    solution = Circuit(probed, sparse=sparse, dtype=dtype,
                       device=device).solve()
    return _potential_difference(solution, probed, a, b)


def resistance_sensitivities(netlist: Netlist, a: str, b: str, *,
                             device="cuda") -> dict[str, float]:
    """d R_eq(a, b) / d R_k for every resistor, by the adjoint method: one
    f64 solve plus one adjoint solve on ``device``, whatever the number of
    resistors.  Returns ``{resistor name: dR_eq/dR}`` in Ω/Ω.  Same
    validation as :func:`equivalent_resistance`.
    """
    probed = _probed(netlist, a, b)
    circuit = Circuit(probed, device=device)
    # 1 A probe: the potential difference is R_eq; ground is 0 V.
    weights: dict[int, float] = {}
    for node, sign in ((a, 1.0), (b, -1.0)):
        if node != probed.ground:
            i = probed.nodenum[node]
            weights[i] = weights.get(i, 0.0) + sign
    g = _adjoint_grad(circuit, weights)
    slot = circuit.stamps.param_slot
    return {name: float(g[slot[name]])
            for name, comp in probed.components.items()
            if comp.type == "R"}


def _potential_difference(solution, probed: Netlist, a: str, b: str
                          ) -> float:
    # Ground is the 0 V reference; the literal label "g" is special-cased to
    # 0 exactly as the reference does (equiv.py:55-61) even when a different
    # node was elected ground.
    def potential(node: str) -> float:
        if node == "g":
            return 0.0
        if node == probed.ground:
            return 0.0
        return float(solution.result[probed.nodenum[node]])

    return potential(a) - potential(b)
