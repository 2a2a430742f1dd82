"""The unbanded random resistor network on the ``block`` tier (the
benchmark's ``randnet1k``, here at 300 nodes): the tier the program picks,
its answers against a plain dense f64 solve, and the contract layer's
residual, whose rows here are wider than the one-slot-row fold takes.

The residual folds every row's entries in a fixed order with no atomics:
narrow rows one slot row each (bit for bit the earlier fold on the mesh
and the lattice), wide rows left to right over the entries sorted by row
(``batch.py:_RowFold``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import randnet_rows  # noqa: E402
from nodal_tpu_torch import BatchedSolver, Circuit, Netlist  # noqa: E402
from nodal_tpu_torch import batch as tbatch  # noqa: E402
from nodal_tpu_torch.models.stamps import stamp_values  # noqa: E402
from nodal_tpu_torch.utils.gridgen import (  # noqa: E402
    grid_rows, weighted_lattice_rows)

#: 300 nodes, 1200 draws, a ground tie on every 50th node: chip_smoke.py's
#: class (1000, 4000) at a size whose ``auto`` tier is still ``block`` (at
#: 200 nodes RCM finds a band).
NODES, EDGES, BATCH = 300, 1200, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside other test processes the default pool
    oversubscribes the cores (and the CPU build's batched f64 solve was
    seen to hang at two threads or more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def randnet():
    rows = randnet_rows(NODES, EDGES)
    circuit = Circuit(Netlist.from_rows(rows))
    rng = np.random.default_rng(5)
    base = circuit.stamps.params
    params = (base * (1.0 + 0.05 * rng.standard_normal((BATCH, len(base))))
              ).astype(np.float32).astype(np.float64)
    return rows, circuit, params


def _dense_reference(rows, nodenum, params):
    """Node potentials of each parameter sample by a plain dense f64 solve
    of the nodal equations (unit-free R and A rows, ground ``g``)."""
    n = len(nodenum)
    out = np.empty((len(params), n))
    for s, p in enumerate(params):
        G, b = np.zeros((n, n)), np.zeros(n)
        for k, (_, kind, _, a, c) in enumerate(rows):
            ia, ic = nodenum.get(a), nodenum.get(c)
            if kind == "R":
                g = 1.0 / p[k]
                for i, j, v in ((ia, ia, g), (ic, ic, g), (ia, ic, -g),
                                (ic, ia, -g)):
                    if i is not None and j is not None:
                        G[i, j] += v
            else:
                for i, v in ((ia, p[k]), (ic, -p[k])):
                    if i is not None:
                        b[i] += v
        out[s] = np.linalg.solve(G, b)
    return out


def _rel_err(got, want):
    return float((np.abs(got - want).max(axis=1)
                  / np.abs(want).max(axis=1)).max())


@pytest.mark.parametrize("refine,limit", [("auto", 1e-9), (False, 1e-4)],
                         ids=["auto", "raw"])
def test_randnet_block_tier_against_dense_reference(randnet, refine, limit):
    """The ``block`` tier, picked by the program, against a dense f64
    solve: the ``"auto"`` contract's answer within 1e-9, the raw f32
    tier's within 1e-4 (and not within the contract's 1e-6 on every
    sample, which is what the contract layer repairs)."""
    rows, circuit, params = randnet
    solver = BatchedSolver(circuit, dtype=torch.float32, refine=refine,
                           device="cpu")
    assert solver.method == "block"
    order = {row[0]: k for k, row in enumerate(rows)}
    assert [circuit.stamps.param_slot[name] for name in order] == \
        list(range(len(rows)))
    got = solver(torch.as_tensor(params, dtype=torch.float32)).numpy()
    want = _dense_reference(rows, circuit.netlist.nodenum, params)
    assert _rel_err(got, want) <= limit
    if refine is False:
        assert _rel_err(got, want) > 1e-6


def _state(circuit, params, seed=9):
    stamps = circuit.stamps
    g_vals, rhs_vals = stamp_values(stamps, torch.as_tensor(params))
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (len(params), stamps.n)))
    return stamps, g_vals, rhs_vals, x


def test_wide_rows_fold_in_row_order(randnet):
    """Rows of up to 2·(most resistors at a node) entries take the wide
    fold: every entry once, sorted by row and, within a row, in stamp
    order, each row's segment between its offsets."""
    _, circuit, _ = randnet
    stamps = circuit.stamps
    g, x_cols, rhs = tbatch._resid_gather_tables(stamps)
    counts = np.bincount(stamps.g_rows, minlength=stamps.n)
    assert counts.max() > tbatch._RESID_FOLD_MAX_WIDTH
    assert g.offsets is not None and rhs.offsets is None
    assert np.array_equal(np.diff(g.offsets), counts)
    for r in range(stamps.n):
        ids = g.ids[g.offsets[r]:g.offsets[r + 1]]
        assert np.array_equal(ids, np.nonzero(stamps.g_rows == r)[0])
    assert np.array_equal(x_cols, stamps.g_cols[g.ids])


def test_wide_row_residual_against_dense(randnet):
    """``G·x`` and ``b`` from the COO entries against the assembled dense
    f64 system, to 1e-14 relative; bit for bit across repeated calls and
    across the batch split in two."""
    from nodal_tpu_torch.ops.assemble import assemble_dense

    _, circuit, params = randnet
    stamps, g_vals, rhs_vals, x = _state(circuit, params)
    y = tbatch._coo_apply(stamps, g_vals, x)
    G, b = assemble_dense(stamps, torch.as_tensor(params))
    dense = torch.einsum("bij,bj->bi", G, x)
    assert float((y - dense).abs().max() / dense.abs().max()) <= 1e-14
    assert torch.equal(tbatch._coo_rhs_vec(stamps, rhs_vals, x), b)
    assert torch.equal(tbatch._coo_apply(stamps, g_vals, x), y)
    h = len(params) // 2
    halves = torch.cat([tbatch._coo_apply(stamps, g_vals[:h], x[:h]),
                        tbatch._coo_apply(stamps, g_vals[h:], x[h:])])
    assert torch.equal(halves, y)


def _parent_narrow_apply(stamps, g_vals, xs):
    """The narrow residual as the port computed it before wide rows had a
    fold of their own: one slot row a row, ``(g·valid·x).sum(-1)``."""
    rows = stamps.g_rows.astype(np.int64)
    nnz = len(rows)
    counts = np.bincount(rows, minlength=stamps.n)
    width = int(counts.max())
    order = np.argsort(rows, kind="stable")
    offsets = np.zeros(stamps.n, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    pos = np.arange(nnz, dtype=np.int64) - offsets[rows[order]]
    ids = np.zeros((stamps.n, width), dtype=np.int64)
    valid = np.zeros((stamps.n, width), dtype=np.float64)
    ids[rows[order], pos] = order
    valid[rows[order], pos] = 1.0
    cols = np.zeros_like(ids)
    cols[valid > 0] = stamps.g_cols[ids[valid > 0]]
    ids, cols = torch.as_tensor(ids), torch.as_tensor(cols)
    return (g_vals[:, ids] * torch.as_tensor(valid) * xs[:, cols]).sum(-1)


def _mesh_rows():
    return list(grid_rows(25, 40, (0, 0), (24, 39))) + [
        ["src", "A", "1", "1", "g"]]


def _lattice_rows():
    d, h, w = 7, 10, 10
    return list(weighted_lattice_rows(
        np.ones((d, h, w - 1)), np.ones((d, h - 1, w)),
        np.ones((d - 1, h, w)), (0, 0, 0), (d - 1, h - 1, w - 1))) + [
        ["src", "A", "1", "1", "g"]]


@pytest.mark.parametrize("make_rows", [_mesh_rows, _lattice_rows],
                         ids=["mesh", "lattice"])
def test_narrow_row_residual_unchanged(make_rows):
    """The mesh's and the lattice's rows stay on the one-slot-row fold,
    whose residual is the earlier formula's bit for bit."""
    circuit = Circuit(Netlist.from_rows(make_rows()))
    rng = np.random.default_rng(3)
    base = circuit.stamps.params
    params = base * (1.0 + 0.05 * rng.standard_normal((4, len(base))))
    stamps, g_vals, rhs_vals, x = _state(circuit, params)
    g, _, rhs = tbatch._resid_gather_tables(stamps)
    assert g.offsets is None and rhs.offsets is None
    assert torch.equal(tbatch._coo_apply(stamps, g_vals, x),
                       _parent_narrow_apply(stamps, g_vals, x))
