"""The stamp compiler: lower a Netlist to static MNA stamp tensors.

This replaces the reference's per-component Python stamping loop
(reference nodal/nodal.py:338-398 dispatching into
reference nodal/models.py:13-214, the measured bottleneck at scale —
SURVEY.md §3.5) with a one-time host-side lowering.  Every component type
contributes a small, fixed template of COO entries; the whole netlist becomes

* integer index arrays  (``g_rows``, ``g_cols``, ``rhs_rows``)  — static per
  topology, and
* a *value expression* — each entry's numeric value is
  ``coeff * f(params[p1], e1) * f(params[p2], e2)`` with
  ``f(x, 0) = 1``, ``f(x, 1) = x``, ``f(x, -1) = 1/x``,

where ``params`` is the vector of component values in netlist order.  The
host-side compiler below is the JAX package's, copied verbatim (importing
``nodal_tpu`` would import ``jax``); only :func:`stamp_values` is torch,
evaluated on a ``[..., n_components]`` params tensor so a parameter sweep
is one leading batch dimension.  :func:`stamps_from_reference` carries a
``StampTensors`` built by the JAX package across, for parity tests.

Stamp semantics match the reference models
(reference nodal/models.py) entry for entry, with two deliberate,
documented corrections (SURVEY.md §2.4):

* **Q1** — VCCS gets true transconductance semantics by default; the
  reference routes VCCS rows through its VCVS stamp (nodal.py:377-378).
  ``Quirks(vccs_as_vcvs=True)`` restores reference behavior bit-for-bit.
* **Q2** — current-controlled sources with an *anomalous* driver (E/VCVS/...)
  work here; the reference crashes on them (models.py:146,200 shadowed
  module, plus a missing kcl offset on the branch column).

The controlling-current sign convention for CCVS/CCCS follows the reference
exactly (models.py:136-158, 174-214): with control nodes (c, d) matching the
driver's terminals, the stamped branch equation is
``ea - eb = (r / R_driver) * (ed - ec)`` — i.e. the driver current is
measured flowing d→c.  Golden outputs (doc/test_1.csv, doc/1.6.1.csv) pin
this down.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from nodal_tpu_torch import constants as const
from nodal_tpu_torch.netlist import Component, Netlist

# Parameter-dependence exponents for one stamp entry factor.
_CONST = 0  # factor is 1 (entry value does not involve this param slot)
_LIN = 1  # factor is params[slot]
_INV = -1  # factor is 1 / params[slot]


@dataclass(frozen=True)
class Quirks:
    """Opt-in bit-compatibility switches for reference divergences."""

    #: Stamp VCCS rows with VCVS semantics, as the reference dispatcher does
    #: (reference nodal.py:377-378, quirk Q1).
    vccs_as_vcvs: bool = False


@dataclass
class StampTensors:
    """Static COO stamp tensors for one netlist topology.

    Shapes: ``g_*`` have length nnz(G-template), ``rhs_*`` length
    nnz(RHS-template).  ``n`` is the number of MNA unknowns
    (node potentials + branch currents), ``n_kcl`` the node count.
    All arrays are host numpy; the device assembly kernel consumes them.
    """

    n: int
    n_kcl: int
    g_rows: np.ndarray  # int32[nnz]
    g_cols: np.ndarray  # int32[nnz]
    g_coeff: np.ndarray  # float64[nnz]
    g_p1: np.ndarray  # int32[nnz] param slot for first factor
    g_e1: np.ndarray  # int8[nnz]  exponent of first factor
    g_p2: np.ndarray  # int32[nnz]
    g_e2: np.ndarray  # int8[nnz]
    rhs_rows: np.ndarray  # int32[m]
    rhs_coeff: np.ndarray  # float64[m]
    rhs_p1: np.ndarray  # int32[m]
    rhs_e1: np.ndarray  # int8[m]
    rhs_p2: np.ndarray  # int32[m]
    rhs_e2: np.ndarray  # int8[m]
    params: np.ndarray  # float64[n_components] default component values
    param_slot: dict[str, int] = field(default_factory=dict)
    # Per-anomalous-component metadata in anomnum (branch-row) order —
    # consumed by the voltage-constraint reduction of
    # :mod:`nodal_tpu_torch.ops.reduce_e` to recognize ideal-source branch
    # rows without reparsing the netlist.  Empty for synthetic stamp
    # objects.
    anom_types: tuple = ()              # e.g. ("E", "VCCS", ...)
    anom_a: np.ndarray = field(         # anode row index, -1 for ground
        default_factory=lambda: np.zeros(0, np.int32))
    anom_b: np.ndarray = field(         # bnode row index, -1 for ground
        default_factory=lambda: np.zeros(0, np.int32))
    anom_slot: np.ndarray = field(      # param slot of the component
        default_factory=lambda: np.zeros(0, np.int32))

    @property
    def nnz(self) -> int:
        return len(self.g_rows)


class _Builder:
    def __init__(self, netlist: Netlist, quirks: Quirks):
        self.nl = netlist
        self.quirks = quirks
        self.n_kcl = netlist.nums["kcl"]
        self.n = netlist.n_unknowns
        self.g_entries: list[tuple[int, int, float, int, int, int, int]] = []
        self.rhs_entries: list[tuple[int, float, int, int, int, int]] = []
        self.param_slot = {
            name: i for i, name in enumerate(netlist.component_keys)
        }
        self.params = np.array(
            [netlist.components[k].value for k in netlist.component_keys],
            dtype=np.float64,
        )

    # -- index helpers -------------------------------------------------------

    def node(self, label: str) -> int | None:
        """Row/col index of a node, or None for ground."""
        if label == self.nl.ground:
            return None
        return self.nl.nodenum[label]

    def branch(self, name: str) -> int:
        """Row/col index of an anomalous component's branch current."""
        return self.n_kcl + self.nl.anomnum[name]

    # -- entry emission ------------------------------------------------------

    def g(self, row: int | None, col: int | None, coeff: float,
          p1: int = 0, e1: int = _CONST, p2: int = 0, e2: int = _CONST) -> None:
        if row is None or col is None:
            return
        self.g_entries.append((row, col, coeff, p1, e1, p2, e2))

    def rhs(self, row: int | None, coeff: float,
            p1: int = 0, e1: int = _CONST, p2: int = 0, e2: int = _CONST) -> None:
        if row is None:
            return
        self.rhs_entries.append((row, coeff, p1, e1, p2, e2))

    # -- per-type stamps (parity: reference models.py) ------------------------

    def stamp_R(self, c: Component) -> None:
        """Conductance stamp (reference models.py:13-24)."""
        if c.value == 0:
            raise ValueError("Model error: resistors can't have null resistance")
        s = self.param_slot[c.name]
        a, b = self.node(c.anode), self.node(c.bnode)
        self.g(a, a, +1.0, s, _INV)
        self.g(b, b, +1.0, s, _INV)
        self.g(a, b, -1.0, s, _INV)
        self.g(b, a, -1.0, s, _INV)

    def stamp_A(self, c: Component) -> None:
        """Independent current source: RHS only (reference models.py:27-32)."""
        s = self.param_slot[c.name]
        self.rhs(self.node(c.anode), +1.0, s, _LIN)
        self.rhs(self.node(c.bnode), -1.0, s, _LIN)

    def _couple_branch(self, c: Component, br: int) -> None:
        """±1 coupling between a branch-current column and its terminal KCL
        rows, shared by E/VCVS/CCVS (reference models.py:42-50 etc.)."""
        a, b = self.node(c.anode), self.node(c.bnode)
        self.g(br, a, +1.0)
        self.g(a, br, -1.0)
        self.g(br, b, -1.0)
        self.g(b, br, +1.0)

    def stamp_E(self, c: Component) -> None:
        """Ideal voltage source (reference models.py:35-50)."""
        s = self.param_slot[c.name]
        br = self.branch(c.name)
        self.rhs(br, +1.0, s, _LIN)
        self._couple_branch(c, br)

    def stamp_VCVS(self, c: Component) -> None:
        """Voltage-controlled voltage source: branch equation
        ``ea - eb - r*ec + r*ed = 0`` (reference models.py:53-78)."""
        s = self.param_slot[c.name]
        br = self.branch(c.name)
        self._couple_branch(c, br)
        self.g(br, self.node(c.pos_control), -1.0, s, _LIN)
        self.g(br, self.node(c.neg_control), +1.0, s, _LIN)

    def stamp_VCCS(self, c: Component) -> None:
        """Voltage-controlled current source, *correct* semantics
        (reference models.py:81-106 — dead code there, quirk Q1):
        KCL coupling ∓1 on the current column, branch equation
        ``i - g*ec + g*ed = 0``."""
        if self.quirks.vccs_as_vcvs:
            self.stamp_VCVS(c)
            return
        s = self.param_slot[c.name]
        br = self.branch(c.name)
        self.g(self.node(c.anode), br, -1.0)
        self.g(self.node(c.bnode), br, +1.0)
        self.g(br, br, +1.0)
        self.g(br, self.node(c.pos_control), -1.0, s, _LIN)
        self.g(br, self.node(c.neg_control), +1.0, s, _LIN)

    def _driver(self, c: Component) -> Component:
        try:
            return self.nl.components[c.driver]  # type: ignore[index]
        except KeyError:
            raise KeyError(f"Driving component {c.driver} not found") from None

    def _check_control_matches_driver(self, c: Component, d: Component) -> bool:
        """Control nodes must coincide with the driver's terminals
        (reference models.py:123-125, 187-189).  Returns True when the
        orientation is aligned (cnode on the driver's anode)."""
        if c.pos_control == d.anode and c.neg_control == d.bnode:
            return True
        if c.pos_control == d.bnode and c.neg_control == d.anode:
            return False
        raise ValueError(
            f"Control nodes of {c.name} ({c.pos_control},{c.neg_control}) do "
            f"not coincide with terminals of driver {d.name} "
            f"({d.anode},{d.bnode})"
        )

    def stamp_CCVS(self, c: Component) -> None:
        """Current-controlled voltage source (reference models.py:109-158).

        Branch equation ``ea - eb = r * i_driver`` with the driver current
        eliminated per driver type:

        * R driver: ``i_driver = (ed - ec) / R_d`` in the reference's sign
          convention, giving coefficients ``+r/R_d`` on ec and ``-r/R_d``
          on ed (models.py:139-145);
        * anomalous driver: couple to the driver's branch-current column at
          ``kcl + anomnum[driver]`` with ``∓r`` (fixes quirk Q2);
        * A driver: the current is known — RHS gets ``r * I_driver``
          (models.py:155-156; orientation-insensitive, as the reference).
        """
        s = self.param_slot[c.name]
        br = self.branch(c.name)
        d = self._driver(c)
        # Reference write_CCVS validates the control/driver coincidence for
        # every driver type (models.py:120-125).
        aligned = self._check_control_matches_driver(c, d)
        self._couple_branch(c, br)
        if d.type == "R":
            # Reference keys the sign to the user-given (c,d) order, not to
            # the driver alignment (models.py:139-145).
            sd = self.param_slot[d.name]
            self.g(br, self.node(c.pos_control), +1.0, s, _LIN, sd, _INV)
            self.g(br, self.node(c.neg_control), -1.0, s, _LIN, sd, _INV)
        elif d.type in const.ANOMALOUS_TYPES:
            self.g(br, self.branch(d.name), -1.0 if aligned else +1.0, s, _LIN)
        elif d.type == "A":
            sd = self.param_slot[d.name]
            self.rhs(br, +1.0, s, _LIN, sd, _LIN)
        else:
            raise ValueError(f"Unknown driver type: {d.type}")

    def stamp_CCCS(self, c: Component) -> None:
        """Current-controlled current source (reference models.py:161-214):
        KCL coupling ∓1 on its own current column, branch equation
        ``i = g * i_driver`` with the same three driver cases as CCVS."""
        s = self.param_slot[c.name]
        br = self.branch(c.name)
        d = self._driver(c)
        self.g(self.node(c.anode), br, -1.0)
        self.g(self.node(c.bnode), br, +1.0)
        self.g(br, br, +1.0)
        if d.type == "R":
            self._check_control_matches_driver(c, d)
            sd = self.param_slot[d.name]
            self.g(br, self.node(c.pos_control), +1.0, s, _LIN, sd, _INV)
            self.g(br, self.node(c.neg_control), -1.0, s, _LIN, sd, _INV)
        elif d.type in const.ANOMALOUS_TYPES:
            aligned = self._check_control_matches_driver(c, d)
            self.g(br, self.branch(d.name), -1.0 if aligned else +1.0, s, _LIN)
        elif d.type == "A":
            sd = self.param_slot[d.name]
            self.rhs(br, +1.0, s, _LIN, sd, _LIN)
        else:
            raise ValueError(f"Unknown driver type: {d.type}")

    # -- dispatch -------------------------------------------------------------

    def build(self) -> StampTensors:
        dispatch = {
            "R": self.stamp_R,
            "A": self.stamp_A,
            "E": self.stamp_E,
            "VCVS": self.stamp_VCVS,
            "VCCS": self.stamp_VCCS,
            "CCVS": self.stamp_CCVS,
            "CCCS": self.stamp_CCCS,
        }
        for key in self.nl.component_keys:
            comp = self.nl.components[key]
            if comp.type == "OPAMP":
                # Parity: reference nodal.py:385-386 — only OPMODEL has a
                # working macromodel; a bare OPAMP has no stamp.
                raise NotImplementedError(
                    "OPAMP has no device model; use OPMODEL"
                )
            dispatch[comp.type](comp)

        # Anomalous-branch metadata in anomnum order (branch row
        # kcl + anomnum[name]); node indices -1 encode ground.
        anom_names = sorted(self.nl.anomnum, key=self.nl.anomnum.get)
        anom_types = tuple(self.nl.components[k].type for k in anom_names)
        def _nidx(label):
            i = self.node(label)
            return -1 if i is None else i
        anom_a = np.array(
            [_nidx(self.nl.components[k].anode) for k in anom_names],
            dtype=np.int32)
        anom_b = np.array(
            [_nidx(self.nl.components[k].bnode) for k in anom_names],
            dtype=np.int32)
        anom_slot = np.array(
            [self.param_slot[k] for k in anom_names], dtype=np.int32)

        ge = self.g_entries
        re = self.rhs_entries
        return StampTensors(
            n=self.n,
            n_kcl=self.n_kcl,
            g_rows=np.array([e[0] for e in ge], dtype=np.int32),
            g_cols=np.array([e[1] for e in ge], dtype=np.int32),
            g_coeff=np.array([e[2] for e in ge], dtype=np.float64),
            g_p1=np.array([e[3] for e in ge], dtype=np.int32),
            g_e1=np.array([e[4] for e in ge], dtype=np.int8),
            g_p2=np.array([e[5] for e in ge], dtype=np.int32),
            g_e2=np.array([e[6] for e in ge], dtype=np.int8),
            rhs_rows=np.array([e[0] for e in re], dtype=np.int32),
            rhs_coeff=np.array([e[1] for e in re], dtype=np.float64),
            rhs_p1=np.array([e[2] for e in re], dtype=np.int32),
            rhs_e1=np.array([e[3] for e in re], dtype=np.int8),
            rhs_p2=np.array([e[4] for e in re], dtype=np.int32),
            rhs_e2=np.array([e[5] for e in re], dtype=np.int8),
            params=self.params,
            param_slot=self.param_slot,
            anom_types=anom_types,
            anom_a=anom_a,
            anom_b=anom_b,
            anom_slot=anom_slot,
        )


def compile_stamps(netlist: Netlist, quirks: Quirks | None = None) -> StampTensors:
    """Lower a finalized Netlist to its static stamp tensors."""
    return _Builder(netlist, quirks or Quirks()).build()


def stamp_values_np(stamps: StampTensors, params: np.ndarray):
    """Numpy mirror of :func:`stamp_values` for host-side setup work
    (e.g. AMG hierarchy construction)."""

    def factor(p_idx, exp):
        x = params[p_idx]
        return np.where(exp == _LIN, x, np.where(exp == _INV, 1.0 / x, 1.0))

    g_vals = (
        stamps.g_coeff
        * factor(stamps.g_p1, stamps.g_e1)
        * factor(stamps.g_p2, stamps.g_e2)
    )
    rhs_vals = (
        stamps.rhs_coeff
        * factor(stamps.rhs_p1, stamps.rhs_e1)
        * factor(stamps.rhs_p2, stamps.rhs_e2)
    )
    return g_vals, rhs_vals


def device_table(owner, name: str, array, device,
                 dtype=None) -> torch.Tensor:
    """``array`` (a static host table of one topology) as a tensor on
    ``device``, copied once and cached on ``owner`` (the stamps, or a plan
    built from them) under ``name``.

    The JAX package bakes these tables into the compiled program as
    constants; eager torch would otherwise copy them host-to-device on
    every call."""
    cache = owner.__dict__.setdefault("_device_tables", {})
    key = (name, str(torch.device(device)), dtype)
    t = cache.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(array), dtype=dtype, device=device)
        cache[key] = t
    return t


def stamp_values(stamps: StampTensors, params: torch.Tensor):
    """Evaluate the stamp value expressions for ``[..., n_components]``
    params.

    Returns ``(g_vals [..., nnz], rhs_vals [..., m])`` in the dtype and on
    the device of ``params``.
    """
    dev, dtype = params.device, params.dtype

    def factor(tag, p_idx, exp):
        x = params[..., device_table(stamps, tag + "_p", p_idx, dev,
                                     torch.long)]
        e = device_table(stamps, tag + "_e", exp, dev, torch.int8)
        # Double-where so reverse-mode stays NaN-free: 1/x is evaluated on
        # every slot (where only masks), and a legal zero-valued component
        # (a 0 V source) referenced by a non-INV slot would otherwise feed
        # -1/x² · 0 = NaN into the gradient.  Genuinely-INV slots can't be
        # zero (null resistance is rejected at parse time).
        inv = e == _INV
        safe = torch.where(inv, x, 1.0)
        return torch.where(e == _LIN, x, torch.where(inv, 1.0 / safe, 1.0))

    g_vals = (
        device_table(stamps, "g_coeff", stamps.g_coeff, dev, dtype)
        * factor("g1", stamps.g_p1, stamps.g_e1)
        * factor("g2", stamps.g_p2, stamps.g_e2)
    )
    rhs_vals = (
        device_table(stamps, "rhs_coeff", stamps.rhs_coeff, dev, dtype)
        * factor("r1", stamps.rhs_p1, stamps.rhs_e1)
        * factor("r2", stamps.rhs_p2, stamps.rhs_e2)
    )
    return g_vals, rhs_vals


def stamps_from_reference(obj) -> StampTensors:
    """A port :class:`StampTensors` from any object carrying the same fields
    as numpy arrays (e.g. the JAX package's own ``StampTensors``), so both
    packages can run on identical stamps.  Arrays and the slot table are
    copied; no cache of ``obj`` is carried over."""
    kwargs = {}
    for f in dataclasses.fields(StampTensors):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, dict):
            v = dict(v)
        elif isinstance(v, (list, tuple)):
            v = tuple(v)
        kwargs[f.name] = v
    return StampTensors(**kwargs)
