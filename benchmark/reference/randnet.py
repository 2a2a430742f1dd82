"""Netlist rows of the benchmark's random resistor networks, made here so
that the program and the plain reference are handed the same rows.

A frozen copy of the random network that ``chip_smoke.py`` drives
(``randnet_rows``; the JAX package's tests build the same graph as
``_random_graph_rows``): an Erdős–Rényi G(n, m) graph (Erdős and Rényi,
1959) of unit resistors between uniform random node pairs.  A row is
``[name, type, value, node_a, node_b]``.
"""

from __future__ import annotations

import numpy as np


def randnet_rows(nodes: int, edges: int, tie_every: int,
                 source_amps: float = 1.0, seed: int = 0):
    """A current source of ``source_amps`` into ``n0`` (row ``v``), then
    ``edges`` draws of a node pair from ``default_rng(seed)``, each pair of
    two distinct nodes a unit resistor ``r<k>`` (a pair drawn twice is two
    resistors, a node drawn twice no row), then a unit resistor to ground
    ``g`` on every ``tie_every``-th node from ``n0`` (``rg<j>``).  1000
    nodes, 4000 draws and a tie every 50th node are ``chip_smoke.py``'s
    ``randnet_rows()``."""
    gen = np.random.default_rng(seed)
    rows = [["v", "A", f"{source_amps:g}", "n0", "g"]]
    for k in range(edges):
        a, b = gen.integers(0, nodes, 2)
        if a != b:
            rows.append([f"r{k}", "R", "1", f"n{a}", f"n{b}"])
    return rows + [[f"rg{j}", "R", "1", f"n{j}", "g"]
                   for j in range(0, nodes, tie_every)]
