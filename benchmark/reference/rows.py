"""Netlist rows of the benchmark's circuits, made here so that the program
and the plain reference are handed the same rows.

A frozen copy of the row generator of ``nodal_tpu_torch/utils/gridgen.py``
(``grid_rows``) and of the 25-row IR-drop mesh that the JAX package's bench
and ``chip_smoke.py`` drive (``_mesh_circuit`` / ``mesh_rows``).  A row is
``[name, type, value, node_a, node_b]``.
"""

from __future__ import annotations


def grid_rows(h: int, w: int, probe_a=None, probe_b=None,
              resistance: float = 1.0):
    """Rows of an h×w grid of equal resistors between 4-neighbours; the
    probe nodes are named ``1`` and ``g`` (``g`` is ground)."""

    def name(i: int, j: int) -> str:
        if probe_a is not None and (i, j) == tuple(probe_a):
            return "1"
        if probe_b is not None and (i, j) == tuple(probe_b):
            return "g"
        return f"n{i}_{j}"

    value = repr(resistance)
    rows = []
    for i in range(h):
        for j in range(w):
            if j + 1 < w:
                rows.append([f"rh{i}_{j}", "R", value, name(i, j),
                             name(i, j + 1)])
            if i + 1 < h:
                rows.append([f"rv{i}_{j}", "R", value, name(i, j),
                             name(i + 1, j)])
    return rows


def mesh_rows(h: int, w: int, source_amps: float = 1.0):
    """The IR-drop mesh: h×w unit resistors, grounded at the far corner,
    driven by a current source into the near corner (25×40 is the JAX
    bench's ``_mesh_circuit(1000)``)."""
    return grid_rows(h, w, (0, 0), (h - 1, w - 1)) + [
        ["src", "A", repr(source_amps), "1", "g"]]


def rows_of(circuit: dict):
    """The rows a configuration's ``circuit`` entry names."""
    kind = circuit["kind"]
    if kind == "mesh":
        return mesh_rows(circuit["rows"], circuit["cols"],
                         circuit["source_amps"])
    raise ValueError(f"unknown circuit kind {kind!r}")
