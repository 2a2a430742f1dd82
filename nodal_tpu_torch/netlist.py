"""Host-side netlist front-end: CSV parsing, validation, symbol tables.

This is the stringy, shape-determining half of the framework.  Everything here
runs on the host exactly once per netlist; the output is a set of symbol
tables (`nodenum`, `anomnum`) and an ordered component list that the stamp
compiler (:mod:`nodal_tpu_torch.models.stamps`) lowers to static index/value tensors
for the device.

Functional parity target: the reference front-end
(reference nodal/nodal.py:30-296) including its observable ordering
rules:

* nodes are indexed in first-appearance (CSV order) order, ground excluded
  (reference nodal.py:283-289);
* anomalous components get branch-equation indices in insertion order
  (reference nodal.py:251-253);
* ground election: an explicit ``g`` node wins, otherwise the max-degree node
  with first-appearance tie-break (reference nodal.py:30-42);
* OPMODEL rows macro-expand into primitive rows that are processed *after*
  every primary row (reference nodal.py:231-234, 276-277) — this fixes their
  position in the symbol tables and therefore the printed output order.

Known-divergence notes versus the reference are collected in
``docs/DIVERGENCES.md`` (quirks Q1-Q6 of SURVEY.md §2.4).
"""

from __future__ import annotations

import csv
import logging
from dataclasses import dataclass, field
from typing import Iterable, Sequence

from nodal_tpu_torch import constants as const

logger = logging.getLogger(__name__)

Row = Sequence[str]


class NetlistError(ValueError):
    """A netlist row failed validation.  Subclasses ValueError for parity
    with the reference, which raises bare ValueError (nodal.py:159-178)."""


class UnconnectedCircuitError(Exception):
    """The circuit graph has nodes unreachable from ground, so the MNA
    system is singular.  Same exception name as the reference
    (nodal.py:108-109)."""


def validate_row(data: Row) -> None:
    """Validate one CSV row; raise NetlistError (a ValueError) if malformed.

    Accepts (silently) empty rows and ``#`` comments, mirroring the
    reference's check_input (nodal.py:150-178).  ``data[0][:1]`` (not
    ``[0]``) so a row with an empty name field doesn't crash with
    IndexError.
    """
    if len(data) == 0 or data[0][:1] == "#":
        return
    name = data[const.NCOL]
    if len(data) < 5:
        raise NetlistError(f"Missing arguments for component {name}")
    ctype = data[const.TCOL]
    if ctype not in const.COMPONENT_TYPES:
        raise NetlistError(f"Unknown type {ctype} for component {name}")
    expected = const.ARITY[ctype]
    if len(data) != expected:
        raise NetlistError(
            f"Wrong number of arguments for component {name}: "
            f"expected {expected}, got {len(data)}"
        )
    try:
        float(data[const.VCOL])
    except ValueError:
        raise NetlistError(
            "Bad input: expected a number for component value "
            f"of {name}, got {data[const.VCOL]} instead"
        ) from None


@dataclass(frozen=True)
class Component:
    """One validated electrical component (reference nodal.py:112-148).

    ``pos_control``/``neg_control`` are set for dependent sources, ``driver``
    only for current-controlled ones; otherwise None.
    """

    name: str
    type: str
    value: float
    anode: str
    bnode: str
    pos_control: str | None = None
    neg_control: str | None = None
    driver: str | None = None

    @classmethod
    def from_row(cls, data: Row) -> "Component":
        validate_row(data)
        ctype = data[const.TCOL]
        pos = neg = drv = None
        if ctype in const.DEPENDENT_TYPES:
            pos = data[const.CCOL]
            neg = data[const.DCOL]
            if ctype in const.CURRENT_CONTROLLED_TYPES:
                drv = data[const.PCOL]
        return cls(
            name=data[const.NCOL],
            type=ctype,
            value=float(data[const.VCOL]),
            anode=data[const.ACOL],
            bnode=data[const.BCOL],
            pos_control=pos,
            neg_control=neg,
            driver=drv,
        )

    # Back-compat: the reference exposes validation as an (effectively
    # static) method Component.check_input (tests.py:10-11 calls it unbound).
    def check_input(self, data: Row) -> None:  # noqa: D401 - parity shim
        validate_row(data)


def find_ground_node(degrees: dict[str, int]) -> str:
    """Elect the ground node: explicit ``g`` wins, else the highest-degree
    node; ties broken by insertion (first-appearance) order.

    Parity: reference nodal.py:30-42 — `max` over dict keys returns the first
    maximal key in insertion order.
    """
    if const.GROUND_LABEL in degrees:
        return const.GROUND_LABEL
    return max(degrees, key=degrees.__getitem__)


def build_opmodel(data: Row) -> list[list[str]]:
    """Macro-expand one OPMODEL row into primitive component rows.

    Row layout: [name, "OPMODEL", rf, out, ground, pos, neg]
    (reference nodal.py:45-85).  Produces:

    * ``{name}_ri``   — input resistance OPMODEL_RI between pos and neg
    * ``{name}_ro``   — output resistance OPMODEL_RO between an internal
                        (phony) node and the output terminal
    * ``{name}_vcvs`` — open-loop gain OPMODEL_GAIN from phony to ground,
                        controlled by (pos - neg)
    * ``{name}_rf``   — feedback resistor rf between neg and out, only when
                        rf != "0"; rf == "0" means direct feedback and
                        requires neg == out.
    """
    name = data[const.NCOL]
    rf = data[const.VCOL]
    out = data[const.ACOL]
    gnd = data[const.BCOL]
    pos = data[const.CCOL]
    neg = data[const.DCOL]
    phony = f"{name}_internal_node"

    rows = [
        [f"{name}_ri", "R", str(const.OPMODEL_RI), pos, neg],
        [f"{name}_ro", "R", str(const.OPMODEL_RO), phony, out],
        [f"{name}_vcvs", "VCVS", str(const.OPMODEL_GAIN), phony, gnd, pos, neg],
    ]
    if rf != "0":
        rows.append([f"{name}_rf", "R", rf, neg, out])
    elif neg != out:
        raise NetlistError(
            f"OPMODEL {name}: direct feedback (rf=0) requires the inverting "
            f"terminal to coincide with the output (got {neg!r} vs {out!r})"
        )
    return rows


@dataclass
class Netlist:
    """Parsed netlist with the symbol tables the stamp compiler needs.

    Attribute surface mirrors the reference Netlist (nodal.py:181-296):
    ``nums``, ``degrees``, ``anomnum``, ``components``, ``component_keys``,
    ``ground``, ``nodenum``, ``opmodel_equivalents``.

    Construct from a CSV path (``Netlist(path)``) or from pre-split rows
    (``Netlist.from_rows(rows)``).
    """

    nums: dict[str, int] = field(default_factory=dict)
    degrees: dict[str, int] = field(default_factory=dict)
    anomnum: dict[str, int] = field(default_factory=dict)
    components: dict[str, Component] = field(default_factory=dict)
    component_keys: list[str] = field(default_factory=list)
    ground: str | None = None
    nodenum: dict[str, int] = field(default_factory=dict)
    opmodel_equivalents: list[list[str]] = field(default_factory=list)

    def __init__(self, path: str | None = None):
        self.nums = {"components": 0, "anomalies": 0, "be": 0, "kcl": 0, "opamps": 0}
        self.degrees = {}
        self.anomnum = {}
        self.components = {}
        self.component_keys = []
        self.ground = None
        self.nodenum = {}
        self.opmodel_equivalents = []
        if path is not None:
            self._read_file(path)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_rows(cls, rows: Iterable[Row]) -> "Netlist":
        nl = cls(None)
        for row in rows:
            nl.process_component(list(row))
        nl.finalize()
        return nl

    def _read_file(self, path: str) -> None:
        try:
            with open(path, "r", newline="") as fh:
                reader = csv.reader(fh, skipinitialspace=True)
                for row in reader:
                    self.process_component(row)
        except FileNotFoundError:
            logger.error("File '%s' not found.", path)
            raise
        self.finalize()

    def process_component(self, data: Row) -> None:
        """Register one CSV row: build the Component, update counters.

        Mirrors reference nodal.py:222-257.  OPMODEL rows are queued for
        deferred expansion by :meth:`finalize`.
        """
        if not data or data[0][:1] == "#":
            return
        if len(data) > const.TCOL and data[const.TCOL] == "OPMODEL":
            validate_row(data)
            self.opmodel_equivalents.extend(build_opmodel(data))
            return

        # from_row validates (clean NetlistError even for truncated rows).
        comp = Component.from_row(data)
        if comp.name in self.components:
            raise NetlistError(f"Duplicate component name {comp.name!r}")
        self.component_keys.append(comp.name)
        self.components[comp.name] = comp

        self.nums["components"] += 1
        if comp.type in const.ANOMALOUS_TYPES:
            self.anomnum[comp.name] = self.nums["anomalies"]
            self.nums["anomalies"] += 1
        for node in (comp.anode, comp.bnode):
            self.degrees[node] = self.degrees.get(node, 0) + 1

    def finalize(self) -> None:
        """Expand queued OPMODEL rows, elect ground, number the nodes.

        Mirrors reference nodal.py:276-296.  Idempotent re-finalization after
        adding components (used by the equivalent-resistance probe injection)
        is supported: node numbering is recomputed from scratch.
        """
        pending, self.opmodel_equivalents = self.opmodel_equivalents, []
        for row in pending:
            self.process_component(row)
        if not self.degrees:
            raise NetlistError("Empty netlist: no components found")

        self.ground = find_ground_node(self.degrees)
        self.nodenum = {
            node: i
            for i, node in enumerate(k for k in self.degrees if k != self.ground)
        }
        self.nums["kcl"] = len(self.nodenum)
        self.nums["be"] = self.nums["anomalies"]
        logger.debug("ground=%s nodenum=%s nums=%s anomnum=%s",
                     self.ground, self.nodenum, self.nums, self.anomnum)

    # -- derived properties --------------------------------------------------

    @property
    def n_unknowns(self) -> int:
        """Size of the MNA system: node potentials + branch currents."""
        return self.nums["kcl"] + self.nums["be"]

    def fresh_name(self, base: str) -> str:
        """A component name guaranteed not to collide with existing ones.

        Fixes reference quirk Q4 (equiv.py:51 always injects the probe source
        as ``a1``, silently clobbering a user component of the same name).
        """
        if base not in self.components:
            return base
        i = 0
        while f"{base}_{i}" in self.components:
            i += 1
        return f"{base}_{i}"

    def with_component(self, row: Row) -> "Netlist":
        """A new Netlist with one extra component row appended (pure)."""
        nl = Netlist(None)
        for key in self.component_keys:
            c = self.components[key]
            nl.process_component(_component_to_row(c))
        nl.process_component(list(row))
        nl.finalize()
        return nl


def _component_to_row(c: Component) -> list[str]:
    row = [c.name, c.type, repr(c.value), c.anode, c.bnode]
    if c.pos_control is not None:
        row += [c.pos_control, c.neg_control]
        if c.driver is not None:
            row.append(c.driver)
    return row


def is_connected(netlist: Netlist) -> bool:
    """True iff every node is reachable from ground through components.

    Same semantics as the reference BFS (nodal.py:88-105) but O(V+E): the
    reference's ``x not in open_list`` membership test on a list is quadratic
    (SURVEY.md §3.5); we use a visited set.
    """
    adjacency: dict[str, set[str]] = {node: set() for node in netlist.degrees}
    for comp in netlist.components.values():
        adjacency[comp.anode].add(comp.bnode)
        adjacency[comp.bnode].add(comp.anode)

    assert netlist.ground is not None, "finalize() must run before is_connected"
    visited = {netlist.ground}
    frontier = [netlist.ground]
    while frontier:
        node = frontier.pop()
        for nxt in adjacency[node]:
            if nxt not in visited:
                visited.add(nxt)
                frontier.append(nxt)
    return len(visited) == len(netlist.degrees)
