"""Resistor-grid netlist generation (for benchmarks and cross-validation).

Generates the CSV netlists the reference needs hours of Python stamping to
consume at scale, and which nodal_tpu's netlist path handles directly; the
matrix-free path (nodal_tpu.ops.grid) skips the netlist entirely.
"""

from __future__ import annotations

from typing import Iterator


def grid_rows(
    h: int,
    w: int,
    probe_a: tuple[int, int] | None = None,
    probe_b: tuple[int, int] | None = None,
    resistance: float = 1.0,
) -> Iterator[list[str]]:
    """Netlist rows for an H×W grid of equal resistors between 4-neighbors.

    Probe nodes are renamed ``1`` and ``g`` so the netlist drops straight
    into ``nodal-resistance`` (reference equiv.py:66-67 hardcodes that pair).
    """

    def name(i: int, j: int) -> str:
        if probe_a is not None and (i, j) == tuple(probe_a):
            return "1"
        if probe_b is not None and (i, j) == tuple(probe_b):
            return "g"
        return f"n{i}_{j}"

    value = repr(resistance)
    for i in range(h):
        for j in range(w):
            if j + 1 < w:
                yield [f"rh{i}_{j}", "R", value, name(i, j), name(i, j + 1)]
            if i + 1 < h:
                yield [f"rv{i}_{j}", "R", value, name(i, j), name(i + 1, j)]


def grid_csv(
    h: int,
    w: int,
    probe_a: tuple[int, int] | None = None,
    probe_b: tuple[int, int] | None = None,
    resistance: float = 1.0,
) -> str:
    """The same grid as CSV text."""
    return "\n".join(",".join(row) for row in grid_rows(h, w, probe_a, probe_b, resistance)) + "\n"


def weighted_grid_rows(
    gx,
    gy,
    probe_a: tuple[int, int] | None = None,
    probe_b: tuple[int, int] | None = None,
):
    """Netlist rows for a grid with per-edge conductances.

    ``gx[h, w-1]``/``gy[h-1, w]`` are edge conductances (resistance = 1/g),
    matching nodal_tpu.ops.grid_weighted's layout — used to cross-validate
    the matrix-free weighted path against the netlist path.
    """
    h, w = gx.shape[0], gy.shape[1]

    def name(i: int, j: int) -> str:
        if probe_a is not None and (i, j) == tuple(probe_a):
            return "1"
        if probe_b is not None and (i, j) == tuple(probe_b):
            return "g"
        return f"n{i}_{j}"

    for i in range(h):
        for j in range(w - 1):
            yield [f"rh{i}_{j}", "R", repr(1.0 / float(gx[i, j])),
                   name(i, j), name(i, j + 1)]
    for i in range(h - 1):
        for j in range(w):
            yield [f"rv{i}_{j}", "R", repr(1.0 / float(gy[i, j])),
                   name(i, j), name(i + 1, j)]


def weighted_lattice_rows(
    gx,
    gy,
    gz,
    probe_a: tuple[int, int, int] | None = None,
    probe_b: tuple[int, int, int] | None = None,
):
    """Netlist rows for a 3-D lattice with per-edge conductances.

    ``gx[d, h, w-1]``/``gy[d, h-1, w]``/``gz[d-1, h, w]`` are edge
    conductances (resistance = 1/g), matching
    nodal_tpu.ops.grid_weighted3's layout — used to cross-validate the
    matrix-free weighted lattice path against the netlist path.
    """
    d, h, w = gy.shape[0], gx.shape[1], gy.shape[2]

    def name(k: int, i: int, j: int) -> str:
        if probe_a is not None and (k, i, j) == tuple(probe_a):
            return "1"
        if probe_b is not None and (k, i, j) == tuple(probe_b):
            return "g"
        return f"n{k}_{i}_{j}"

    for k in range(d):
        for i in range(h):
            for j in range(w - 1):
                yield [f"rx{k}_{i}_{j}", "R", repr(1.0 / float(gx[k, i, j])),
                       name(k, i, j), name(k, i, j + 1)]
    for k in range(d):
        for i in range(h - 1):
            for j in range(w):
                yield [f"ry{k}_{i}_{j}", "R", repr(1.0 / float(gy[k, i, j])),
                       name(k, i, j), name(k, i + 1, j)]
    for k in range(d - 1):
        for i in range(h):
            for j in range(w):
                yield [f"rz{k}_{i}_{j}", "R", repr(1.0 / float(gz[k, i, j])),
                       name(k, i, j), name(k + 1, i, j)]


def ladder_rows(n: int, resistance: float = 1.0, source: float = 1.0) -> list[list[str]]:
    """An n-rung R-ladder driven by a current source — the 1k-node batched
    sweep benchmark circuit (BASELINE.md 'dense repeat solve' row)."""
    rows: list[list[str]] = [["src", "A", repr(source), "n0", "g"]]
    value = repr(resistance)
    for k in range(n):
        a = f"n{k}"
        b = f"n{k + 1}" if k + 1 < n else "g"
        rows.append([f"rs{k}", "R", value, a, b])
        rows.append([f"rp{k}", "R", value, a, "g"])
    return rows
