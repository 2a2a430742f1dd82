"""Shared constants: netlist CSV schema, component taxonomy, opamp macromodel.

Functional parity target: reference nodal/constants.py (CSV column layout
constants.py:4-12, type taxonomy constants.py:15-30, opamp parameters
constants.py:33-35).  The schema is observable behavior — netlists written for
the reference must parse identically here.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# CSV column layout.  A netlist row is:
#   name, type, value, anode, bnode [, pos_control, neg_control [, driver]]
# ---------------------------------------------------------------------------
NCOL = 0  # component name
TCOL = 1  # component type
VCOL = 2  # component value (resistance, current, voltage, gain, ...)
ACOL = 3  # node on the first lead; positive current enters here
BCOL = 4  # node on the second lead
CCOL = 5  # first node of the controlling variable (dependent sources)
DCOL = 6  # second node of the controlling variable (dependent sources)
PCOL = 7  # name of the driving component (current-controlled sources)

# ---------------------------------------------------------------------------
# Component-type taxonomy.
#   CC    = current-controlled sources (need a named driver component)
#   DEP   = all dependent (controlled) sources
#   ANOM  = "anomalous" components: ones whose branch current becomes an
#           explicit unknown in the MNA system (voltage sources + dependents)
# ---------------------------------------------------------------------------
CURRENT_CONTROLLED_TYPES = ("CCCS", "CCVS")
DEPENDENT_TYPES = ("VCVS", "VCCS") + CURRENT_CONTROLLED_TYPES
ANOMALOUS_TYPES = ("E",) + DEPENDENT_TYPES
COMPONENT_TYPES = ("A", "R") + ANOMALOUS_TYPES + ("OPAMP", "OPMODEL")

# Number of CSV fields each type must carry (including name and type).
ARITY = {
    "OPAMP": 7,
    "OPMODEL": 7,
    "R": 5,
    "A": 5,
    "E": 5,
    "VCCS": 7,
    "VCVS": 7,
    "CCCS": 8,
    "CCVS": 8,
}

# ---------------------------------------------------------------------------
# OPMODEL opamp macromodel parameters (reference constants.py:33-35).
# An OPMODEL row expands into Ri (input resistance), Ro (output resistance),
# a VCVS with the open-loop gain, and an optional feedback resistor.
# ---------------------------------------------------------------------------
OPMODEL_RI = 1e7  # ohm
OPMODEL_RO = 10.0  # ohm
OPMODEL_GAIN = 1e5  # dimensionless

# Name of the implicit ground reference node.
GROUND_LABEL = "g"
