"""Ideal-voltage-constraint reduction: eliminate E-source branch equations
by supernode merging before the bordered elimination.

Counterpart of ``nodal_tpu/ops/reduce_e.py``, host numpy as there: a copy
with its imports rewritten, so both packages build identical plans.

The reference hands any sparse MNA system to SuperLU (reference
nodal.py:325), which is indifferent to how many branch equations the
circuit has.  The bordered elimination of
:mod:`nodal_tpu_torch.ops.sparse_schur` is not: every ideal voltage
source adds one border row, and a circuit with
tens of thousands of E sources ("mostly branch equations") blows past the
dense-Schur border cap.  This module removes exactly those rows *exactly*,
before the elimination runs:

An ideal source ``E`` between nodes a and b contributes one constraint
``e_a − e_b = V`` and one current unknown whose only couplings are ±1 into
the terminal KCL rows.  Nodes connected by such sources therefore form
**supernodes**: pick one representative per E-connected group, express
every member as ``e_i = ê_rep + q_i`` with offsets ``q`` summed along a
spanning tree of the E edges (groups containing ground have every member
potential known outright), and *sum* the member KCL rows — the eliminated
current columns cancel in the sum because each appears as +1 and −1 inside
one group.  The reduced system drops one node unknown, one current
unknown, and one branch row per eliminated source, and its node block is
again a resistor Laplacian — exactly the structure the AMG-CG/Schur path
wants.  Eliminated branch currents are recovered afterwards by peeling the
spanning tree leaf-to-root against the original KCL defects (each tree
edge's current is determined by the already-resolved subtree below it).

A *cycle* of ideal sources (a loop of E's, parallel E's, an E from ground
to ground) makes the branch currents structurally indeterminate; the
reference's dense path raises ``LinAlgError`` there (its sparse path
returns NaNs — quirk Q3), and this module raises the same
``numpy.linalg.LinAlgError("Singular matrix")`` uniformly at plan time.

Not every E is eliminable: a current-controlled source driven by an E
reads that E's branch-current column (stamps.py stamp_CCVS/stamp_CCCS),
so eliminating it would orphan the reference.  Such E's simply stay in
the border — the reduction removes the rest.

Scope note: this reduction handles the *ideal-source* border population,
which is what actually grows with circuit size (power/ground rails, bias
strings).  Controlled sources (VCVS/VCCS/CCVS/CCCS) stay border rows; a
circuit with more of them after reduction than the border cap of its
device still refuses the bordered elimination loudly (see
sparse_schur.solve_general_auto).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from nodal_tpu_torch.models.stamps import StampTensors


@dataclass
class EReduction:
    """Topology-level reduction plan (value-independent).

    ``stamps_red`` is a synthetic :class:`StampTensors` sharing the
    original parameter vector/slots, so every value-dependent entry of the
    reduced matrix still folds from ``params`` — the bordered elimination's
    factorization caches (keyed on folded values) work unchanged on it.
    Its RHS template is empty: the reduced right-hand side depends on the
    offsets ``q`` (value-dependent) and is computed numerically per solve
    by :func:`reduced_rhs`.
    """

    n: int
    n_kcl: int
    n_be: int
    # Eliminated / kept anomalous components (indices into anomnum order).
    elim: np.ndarray          # int64[k]
    keep_anom: np.ndarray     # int64[n_be - k]
    # Grouping: group_id[i] >= 0 for nodes in an E-connected group
    # (-1 for ungrouped); ground_group is the id containing ground, or -1.
    group_id: np.ndarray      # int32[n_kcl]
    ground_group: int
    # Row/col maps into the reduced system (-1 = dropped).
    row_red: np.ndarray       # int64[n]
    col_red: np.ndarray       # int64[n]
    n_red: int
    n_kcl_red: int
    # Kept stamp entries (indices into the original g arrays) and the
    # subset needing a q-correction on the RHS (grouped node columns).
    entry_keep: np.ndarray    # int64[]
    entry_qcorr: np.ndarray   # int64[] (row_red >= 0, col in a group)
    # Spanning-tree recovery plan, in BFS order (parents before children):
    # child node, parent node (-1 = ground), eliminated anom index of the
    # edge, +1 if the child is the E's anode; level_starts delimits BFS
    # depth levels for vectorized offset propagation.
    tree_child: np.ndarray
    tree_parent: np.ndarray
    tree_edge: np.ndarray
    tree_child_is_anode: np.ndarray  # bool[]
    level_starts: np.ndarray
    stamps_red: StampTensors


def _eliminable_mask(stamps: StampTensors) -> np.ndarray | None:
    """Bool[n_be]: branch rows that are ideal-E constraints whose current
    column is referenced only by its own terminal KCL couplings.  None if
    the stamps carry no anomalous metadata (e.g. native-parsed stamps
    predating the metadata export)."""
    n_be = stamps.n - stamps.n_kcl
    if n_be == 0 or len(stamps.anom_types) != n_be:
        return None
    is_e = np.array([t == "E" for t in stamps.anom_types], dtype=bool)
    if not is_e.any():
        return None
    # A current column may only be read by the E's own terminal rows
    # (a CCVS/CCCS controlled by it reads it from ITS own branch row).
    gc = stamps.g_cols.astype(np.int64)
    gr = stamps.g_rows.astype(np.int64)
    branch_col = gc >= stamps.n_kcl
    j = gc[branch_col] - stamps.n_kcl
    r = gr[branch_col]
    ok_row = (r == stamps.anom_a[j]) | (r == stamps.anom_b[j])
    referenced = np.zeros(n_be, dtype=bool)
    np.logical_or.at(referenced, j[~ok_row], True)
    return is_e & ~referenced


def build_e_reduction(stamps: StampTensors) -> EReduction | None:
    """Build (or decline) the reduction plan for one topology.

    Returns None when nothing is eliminable.  Raises
    ``numpy.linalg.LinAlgError`` on a structural E-cycle (indeterminate
    branch currents — the circuit is singular for the reference too).
    """
    mask = _eliminable_mask(stamps)
    if mask is None or not mask.any():
        return None
    nk = stamps.n_kcl
    elim = np.nonzero(mask)[0].astype(np.int64)
    keep_anom = np.nonzero(~mask)[0].astype(np.int64)

    # Union-find over nodes + a virtual ground vertex (index nk).
    parent = np.arange(nk + 1, dtype=np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:  # path compression
            parent[i], i = root, parent[i]
        return root

    def vid(node_idx):  # -1 (ground) -> the virtual ground vertex
        return nk if node_idx < 0 else int(node_idx)

    for j in elim:
        ra, rb = find(vid(stamps.anom_a[j])), find(vid(stamps.anom_b[j]))
        if ra == rb:
            # E-cycle: loop/parallel ideal sources — currents are
            # structurally indeterminate, the matrix is singular.
            raise np.linalg.LinAlgError("Singular matrix")
        parent[ra] = rb

    root = np.array([find(i) for i in range(nk + 1)], dtype=np.int64)
    ground_root = root[nk]
    # Only roots that an eliminated E actually touches form groups.
    touched = np.zeros(nk + 1, dtype=bool)
    for j in elim:
        touched[root[vid(stamps.anom_a[j])]] = True
        touched[root[vid(stamps.anom_b[j])]] = True
    group_roots = np.nonzero(touched)[0]
    group_of_root = np.full(nk + 1, -1, dtype=np.int32)
    group_of_root[group_roots] = np.arange(len(group_roots), dtype=np.int32)
    group_id = np.where(touched[root[:nk]], group_of_root[root[:nk]], -1)
    ground_group = int(group_of_root[ground_root]) if touched[ground_root] \
        else -1

    # BFS spanning tree per group, rooted at the representative (ground
    # for the ground group, else the smallest-index member).  The union-
    # find guaranteed the E edges form a forest, so BFS = the tree.
    adj_head: dict[int, list[tuple[int, int, bool]]] = {}
    for j in elim:
        a, b = vid(stamps.anom_a[j]), vid(stamps.anom_b[j])
        adj_head.setdefault(a, []).append((b, int(j), False))
        adj_head.setdefault(b, []).append((a, int(j), True))

    rep_of_group = np.full(len(group_roots), -1, dtype=np.int64)
    for g, r in enumerate(group_roots):
        if g == ground_group:
            rep_of_group[g] = nk
        else:
            # smallest-index member (deterministic, independent of
            # union-find internals)
            members = np.nonzero((group_id == g))[0]
            rep_of_group[g] = members.min()

    tree_child, tree_parent, tree_edge, tree_anode = [], [], [], []
    level_starts = [0]
    visited = np.zeros(nk + 1, dtype=bool)
    frontier = [int(r) for r in rep_of_group]
    for v in frontier:
        visited[v] = True
    while frontier:
        nxt = []
        for p in frontier:
            for (child, j, child_is_anode) in adj_head.get(p, ()):
                if visited[child]:
                    continue
                visited[child] = True
                tree_child.append(child)
                tree_parent.append(-1 if p == nk else p)
                tree_edge.append(j)
                tree_anode.append(child_is_anode)
                nxt.append(child)
        if nxt:
            level_starts.append(level_starts[-1] + len(nxt))
        frontier = nxt

    tree_child = np.array(tree_child, dtype=np.int64)
    tree_parent = np.array(tree_parent, dtype=np.int64)
    tree_edge = np.array(tree_edge, dtype=np.int64)
    tree_anode = np.array(tree_anode, dtype=bool)
    level_starts = np.array(level_starts, dtype=np.int64)

    # Reduced node numbering: ungrouped nodes and non-ground group
    # representatives, in original index order (stable output ordering).
    is_unknown_node = (group_id < 0)
    for g in range(len(group_roots)):
        if g != ground_group:
            is_unknown_node[rep_of_group[g]] = True
    node_new = np.cumsum(is_unknown_node) - 1
    n_kcl_red = int(is_unknown_node.sum())

    # Row map: node rows fold onto their group representative's reduced
    # row (ground-group rows are dropped — the merged equation is ground's
    # omitted KCL); branch rows keep/drop.
    rep_node_of = np.full(nk, -1, dtype=np.int64)
    ungrouped = group_id < 0
    rep_node_of[ungrouped] = np.nonzero(ungrouped)[0]
    for g in range(len(group_roots)):
        if g == ground_group:
            continue
        rep_node_of[group_id == g] = rep_of_group[g]

    row_red = np.full(stamps.n, -1, dtype=np.int64)
    has_rep = rep_node_of >= 0
    row_red[:nk][has_rep] = node_new[rep_node_of[has_rep]]
    keep_pos = {int(j): k for k, j in enumerate(keep_anom)}
    for j in keep_anom:
        row_red[nk + j] = n_kcl_red + keep_pos[int(j)]
    col_red = row_red.copy()  # same maps: cols of reps / kept branches
    n_red = n_kcl_red + len(keep_anom)

    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    rr = row_red[gr]
    cc = col_red[gc]
    grouped_node_col = (gc < nk) & (group_id[np.clip(gc, 0, nk - 1)] >= 0) \
        if nk else np.zeros(len(gc), dtype=bool)
    # Keep: live row AND live column.  Entries whose column was dropped:
    # ground-group node columns are known potentials (q-correction, below);
    # eliminated current columns cancel pairwise inside the summed group
    # row (structural: ±1 with both terminals in one group).
    entry_keep = np.nonzero((rr >= 0) & (cc >= 0))[0].astype(np.int64)
    entry_qcorr = np.nonzero((rr >= 0) & grouped_node_col)[0].astype(np.int64)

    stamps_red = StampTensors(
        n=n_red,
        n_kcl=n_kcl_red,
        g_rows=rr[entry_keep].astype(np.int32),
        g_cols=cc[entry_keep].astype(np.int32),
        g_coeff=stamps.g_coeff[entry_keep],
        g_p1=stamps.g_p1[entry_keep],
        g_e1=stamps.g_e1[entry_keep],
        g_p2=stamps.g_p2[entry_keep],
        g_e2=stamps.g_e2[entry_keep],
        rhs_rows=np.zeros(0, np.int32),
        rhs_coeff=np.zeros(0, np.float64),
        rhs_p1=np.zeros(0, np.int32),
        rhs_e1=np.zeros(0, np.int8),
        rhs_p2=np.zeros(0, np.int32),
        rhs_e2=np.zeros(0, np.int8),
        params=stamps.params,
        param_slot=stamps.param_slot,
        anom_types=tuple(stamps.anom_types[int(j)] for j in keep_anom),
        anom_a=np.array(
            [_remap_node(col_red, stamps.anom_a[int(j)])
             for j in keep_anom], dtype=np.int32),
        anom_b=np.array(
            [_remap_node(col_red, stamps.anom_b[int(j)])
             for j in keep_anom], dtype=np.int32),
        anom_slot=stamps.anom_slot[keep_anom]
        if len(keep_anom) else np.zeros(0, np.int32),
    )
    return EReduction(
        n=stamps.n, n_kcl=nk, n_be=stamps.n - nk,
        elim=elim, keep_anom=keep_anom,
        group_id=group_id, ground_group=ground_group,
        row_red=row_red, col_red=col_red,
        n_red=n_red, n_kcl_red=n_kcl_red,
        entry_keep=entry_keep, entry_qcorr=entry_qcorr,
        tree_child=tree_child, tree_parent=tree_parent,
        tree_edge=tree_edge, tree_child_is_anode=tree_anode,
        level_starts=level_starts,
        stamps_red=stamps_red,
    )


def _remap_node(col_red, idx):
    if idx < 0:
        return -1
    m = int(col_red[idx])
    return m if 0 <= m else -1  # grouped-with-ground terminals act as ground


def e_reduction_or_none(stamps: StampTensors) -> EReduction | None:
    """Cached :func:`build_e_reduction` (topology-level, one per stamps)."""
    cached = getattr(stamps, "_e_reduction", "unset")
    if cached != "unset":
        return cached
    red = build_e_reduction(stamps)
    stamps._e_reduction = red  # type: ignore[attr-defined]
    return red


def offsets(red: EReduction, stamps: StampTensors, params) -> np.ndarray:
    """q[i] per original node: e_i − ê_rep(i) (ground group: e_i outright);
    0 for ungrouped nodes.  Propagated level-by-level down the spanning
    tree: branch equation ``e_a − e_b = V`` gives
    ``e_child = e_parent ± V``."""
    V = params[stamps.anom_slot[red.tree_edge]] if len(red.tree_edge) \
        else np.zeros(0)
    return offsets_from_branch_values(red, V)


def offsets_from_branch_values(red: EReduction, V) -> np.ndarray:
    """:func:`offsets` with explicit per-tree-edge branch voltages ``V``
    (one entry per ``red.tree_edge``) instead of netlist parameters.

    Used by the outer defect-correction loop in
    ``sparse_schur.solve_general_auto``: a correction system ``G dx = r``
    has branch-row "voltages" ``r[n_kcl + tree_edge]`` (roundoff-scale,
    but carrying them keeps each pass an exact solve of the residual
    equation rather than an approximation of it)."""
    q = np.zeros(red.n_kcl, dtype=np.float64)
    sign = np.where(red.tree_child_is_anode, 1.0, -1.0)
    ls = red.level_starts
    for lv in range(len(ls) - 1):
        sl = slice(ls[lv], ls[lv + 1])
        p = red.tree_parent[sl]
        pq = np.where(p >= 0, q[np.clip(p, 0, None)], 0.0)
        q[red.tree_child[sl]] = pq + sign[sl] * V[sl]
    return q


def reduced_rhs(red: EReduction, stamps: StampTensors, g_vals, b_full,
                q) -> np.ndarray:
    """Reduced right-hand side: group-summed b minus the known-potential
    contributions ``g·q`` of every grouped node column."""
    b_red = np.zeros(red.n_red, dtype=np.float64)
    live = red.row_red >= 0
    np.add.at(b_red, red.row_red[live], b_full[live])
    e = red.entry_qcorr
    if len(e):
        gr = stamps.g_rows.astype(np.int64)[e]
        gc = stamps.g_cols.astype(np.int64)[e]
        np.subtract.at(b_red, red.row_red[gr], g_vals[e] * q[gc])
    return b_red


def expand_solution(red: EReduction, stamps: StampTensors, x_red,
                    g_vals, b_full, q) -> np.ndarray:
    """Lift a reduced solution to the full unknown vector: member
    potentials from ``ê_rep + q``, kept currents pass through, eliminated
    currents recovered by leaf-to-root tree peeling against the original
    KCL defects."""
    nk = red.n_kcl
    x = np.empty(stamps.n, dtype=np.float64)
    # Node potentials.
    red_col = red.col_red[:nk]
    known = red_col < 0  # ground-group members
    x[:nk][~known] = x_red[red_col[~known]]
    x[:nk][known] = 0.0
    x[:nk] += q  # q is 0 for ungrouped, offset for grouped
    # Kept branch currents.
    for k, j in enumerate(red.keep_anom):
        x[nk + j] = x_red[red.n_kcl_red + k]

    if len(red.tree_edge) == 0:
        return x

    # KCL defects with eliminated current columns zeroed (x[nk+elim] = 0
    # for now), then peel deepest-level-first: each tree edge's ±1 entry
    # in its CHILD's row is the only unresolved term there.
    x_tmp = x.copy()
    x_tmp[nk + red.elim] = 0.0
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    y = np.zeros(stamps.n, dtype=np.float64)
    np.add.at(y, gr, g_vals * x_tmp[gc])
    d = b_full - y  # defect; only grouped node rows matter below

    ls = red.level_starts
    # G[child_row, br_edge]: -1 where child is the anode (stamp_E couples
    # g(a, br, -1), g(b, br, +1)).
    coeff_child = np.where(red.tree_child_is_anode, -1.0, 1.0)
    for lv in range(len(ls) - 1, 0, -1):
        sl = slice(ls[lv - 1], ls[lv])
        child = red.tree_child[sl]
        i_edge = d[child] / coeff_child[sl]
        x[nk + red.tree_edge[sl]] = i_edge
        p = red.tree_parent[sl]
        live = p >= 0
        # parent-row coupling has the opposite sign of the child's
        np.add.at(d, p[live], coeff_child[sl][live] * i_edge[live])
    return x


# -- transpose (adjoint) direction --------------------------------------------
#
# Gᵀ y = c reduces through the SAME plan with row/column roles swapped:
# the eliminated current COLUMNS become tree constraints on the adjoint
# node-row values (−y_a + y_b = c[br] per source, the dual of the forward
# potential offsets), the eliminated branch ROWS' adjoints drop out of the
# group-summed transpose equations by the same ±1 cancellation, and are
# recovered afterwards by peeling the tree against the grouped node
# COLUMNS' transpose equations.  (L G R)ᵀ = Rᵀ Gᵀ Lᵀ, so the reduced
# transpose matrix is exactly stamps_red transposed — one factorization
# serves both directions, as in sparse_schur.


def offsets_transpose(red: EReduction, c_full) -> np.ndarray:
    """p[i] per original node ROW: the adjoint offset y_i − ŷ_rep(i)
    (ground group: y_i outright).  Column br of an eliminated E reads
    ``−y_a + y_b = c[br]``, so down the tree: y_child = y_parent ± c[br]
    with +1 when the child is the BNODE (dual sign of :func:`offsets`)."""
    nk = red.n_kcl
    p = np.zeros(nk, dtype=np.float64)
    if not len(red.tree_edge):
        return p
    cvals = c_full[nk + red.tree_edge]
    sign = np.where(red.tree_child_is_anode, -1.0, 1.0)
    ls = red.level_starts
    for lv in range(len(ls) - 1):
        sl = slice(ls[lv], ls[lv + 1])
        par = red.tree_parent[sl]
        pq = np.where(par >= 0, p[np.clip(par, 0, None)], 0.0)
        p[red.tree_child[sl]] = pq + sign[sl] * cvals[sl]
    return p


def reduced_rhs_transpose(red: EReduction, stamps: StampTensors, g_vals,
                          c_full, p) -> np.ndarray:
    """Reduced adjoint right-hand side: column-folded c minus the known
    offset contributions ``Gᵀ p`` of every grouped node row."""
    c_red = np.zeros(red.n_red, dtype=np.float64)
    live = red.col_red >= 0
    np.add.at(c_red, red.col_red[live], c_full[live])
    # Entries whose ROW is a grouped node contribute v·p[row] to their
    # column's transpose equation; fold into live columns.
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    nk = red.n_kcl
    grouped_row = (gr < nk)
    if nk:
        grouped_row &= red.group_id[np.clip(gr, 0, nk - 1)] >= 0
    sel = grouped_row & (red.col_red[gc] >= 0)
    idx = np.nonzero(sel)[0]
    if len(idx):
        np.subtract.at(c_red, red.col_red[gc[idx]],
                       g_vals[idx] * p[gr[idx]])
    return c_red


def expand_solution_transpose(red: EReduction, stamps: StampTensors, y_red,
                              g_vals, c_full, p) -> np.ndarray:
    """Lift a reduced adjoint solution: grouped node-row adjoints from
    ``ŷ_rep + p``, ground-group rows from ``p`` alone, kept branch rows
    pass through, eliminated branch-row adjoints recovered by peeling the
    tree against the grouped node COLUMNS' transpose equations."""
    nk = red.n_kcl
    y = np.empty(stamps.n, dtype=np.float64)
    red_row = red.row_red[:nk]
    known = red_row < 0
    y[:nk][~known] = y_red[red_row[~known]]
    y[:nk][known] = 0.0
    y[:nk] += p
    for k, j in enumerate(red.keep_anom):
        y[nk + j] = y_red[red.n_kcl_red + k]
    if not len(red.tree_edge):
        return y

    y_tmp = y.copy()
    y_tmp[nk + red.elim] = 0.0
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    z = np.zeros(stamps.n, dtype=np.float64)
    np.add.at(z, gc, g_vals * y_tmp[gr])  # Gᵀ y with eliminated rows zeroed
    d = c_full - z  # defect; grouped node COLUMNS matter below

    ls = red.level_starts
    # G[br_edge, child_col]: +1 where the child is the anode (stamp_E's
    # branch row is e_a − e_b = V).
    coeff_child = np.where(red.tree_child_is_anode, 1.0, -1.0)
    for lv in range(len(ls) - 1, 0, -1):
        sl = slice(ls[lv - 1], ls[lv])
        child = red.tree_child[sl]
        y_edge = d[child] / coeff_child[sl]
        y[nk + red.tree_edge[sl]] = y_edge
        par = red.tree_parent[sl]
        live = par >= 0
        # parent-column coupling has the opposite sign of the child's
        np.add.at(d, par[live], coeff_child[sl][live] * y_edge[live])
    return y
