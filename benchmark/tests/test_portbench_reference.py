"""The plain references against the port's plain CPU path at small sizes,
and the grid reference against a dense pseudo-inverse."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from reference import grid as ref_grid
from reference import mna
from reference.rows import mesh_rows


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_mesh_reference_agrees_with_the_port():
    from nodal_tpu_torch import BatchedSolver, Circuit, Netlist

    rows = mesh_rows(5, 8)
    ref = mna.ResistiveMNA(rows)
    circuit = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(circuit, device="cpu")
    assert solver.method == "sband" and ref.n == 39 and ref.m == 68
    assert [circuit.stamps.param_slot[r[0]] for r in rows] == \
        list(range(len(rows)))
    gen = np.random.default_rng(4)
    params = (ref.values(rows) * (1 + 0.05 * gen.standard_normal(
        (4, ref.m)))).astype(np.float32)
    x = solver(torch.tensor(params)).numpy()
    want = ref.solve(params.astype(np.float64))
    assert mna.rel_errors(x, want).max() < 1e-10
    raw = BatchedSolver(circuit, refine=False, device="cpu")
    err = mna.rel_errors(raw(torch.tensor(params)).double().numpy(), want)
    assert 1e-9 < err.max() < 1e-4  # f32 rounding, not the contract


def _dense_laplacian(h, w):
    n = h * w
    L = np.zeros((n, n))
    for i in range(h):
        for j in range(w):
            for di, dj in ((1, 0), (0, 1)):
                if i + di < h and j + dj < w:
                    a, b = i * w + j, (i + di) * w + j + dj
                    L[a, a] += 1
                    L[b, b] += 1
                    L[a, b] -= 1
                    L[b, a] -= 1
    return L


def test_grid_reference_is_the_pseudo_inverse():
    h, w = 6, 9
    P = np.linalg.pinv(_dense_laplacian(h, w))
    for a, b in (((0, 0), (5, 8)), ((2, 3), (3, 5)), ((1, 1), (1, 2))):
        e = np.zeros(h * w)
        e[a[0] * w + a[1]], e[b[0] * w + b[1]] = 1.0, -1.0
        assert ref_grid.resistance(h, w, a, b) == pytest.approx(e @ P @ e,
                                                                 rel=1e-12)
        assert ref_grid.resistance(h, w, a, b, 2.5) == pytest.approx(
            2.5 * (e @ P @ e), rel=1e-12)


def test_grid_reference_agrees_with_the_port():
    from nodal_tpu_torch import (grid_equivalent_resistance,
                                 grid_equivalent_resistance_many)

    R, info = grid_equivalent_resistance(32, 32, (10, 11), (11, 13),
                                         dtype=torch.float64, tol=1e-12,
                                         device="cpu")
    assert float(R) == pytest.approx(
        ref_grid.resistance(32, 32, (10, 11), (11, 13)), rel=1e-10)
    pairs = [[(8, 8), (20, 24)], [(16, 16), (17, 18)]]
    Rs, _ = grid_equivalent_resistance_many(32, 32, pairs, tol=1e-6,
                                            device="cpu")
    want = [ref_grid.resistance(32, 32, a, b) for a, b in pairs]
    assert np.allclose(Rs.double().numpy(), want, rtol=1e-5)


def test_grid_control_is_far_from_the_reference():
    """bfloat16 potentials miss R by far more than an f32 solve."""
    h = w = 1024
    a, b = (512, 512), (513, 514)
    exact = ref_grid.resistance(h, w, a, b)
    assert exact == pytest.approx(4 / np.pi - 0.5, rel=1e-5)
    assert abs(ref_grid.resistance_bf16(h, w, a, b) - exact) / exact > 1e-4
