"""Netlist rows of the benchmark's 3-D resistor lattices, made here so that
the program and the plain reference are handed the same rows.

A frozen copy of the lattice that the JAX package's bench and
``chip_smoke.py`` drive (``lattice_rows``, on
``nodal_tpu_torch/utils/gridgen.py:weighted_lattice_rows`` with unit
conductances).  A row is ``[name, type, value, node_a, node_b]``.
"""

from __future__ import annotations


def lattice_rows(d: int, h: int, w: int, source_amps: float = 1.0):
    """A d×h×w lattice of unit resistors between 6-neighbours: the x edges
    (``rx``), then the y edges (``ry``), then the z edges (``rz``), each
    in (k, i, j) order; the corner (0, 0, 0) is node ``1``, the far
    corner ``g`` (ground), and a current source drives ``1`` from ``g``
    (20×10×10 is ``chip_smoke.py``'s ``lattice_rows(20, 10, 10)``)."""
    far = (d - 1, h - 1, w - 1)

    def name(k: int, i: int, j: int) -> str:
        if (k, i, j) == (0, 0, 0):
            return "1"
        if (k, i, j) == far:
            return "g"
        return f"n{k}_{i}_{j}"

    one = repr(1.0)
    rows = []
    for k in range(d):
        for i in range(h):
            for j in range(w - 1):
                rows.append([f"rx{k}_{i}_{j}", "R", one, name(k, i, j),
                             name(k, i, j + 1)])
    for k in range(d):
        for i in range(h - 1):
            for j in range(w):
                rows.append([f"ry{k}_{i}_{j}", "R", one, name(k, i, j),
                             name(k, i + 1, j)])
    for k in range(d - 1):
        for i in range(h):
            for j in range(w):
                rows.append([f"rz{k}_{i}_{j}", "R", one, name(k, i, j),
                             name(k + 1, i, j)])
    return rows + [["src", "A", repr(source_amps), "1", "g"]]
