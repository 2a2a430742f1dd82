"""Each fault a cell can have, planted under the timed path of a whole
run (the look for a chip skipped, the CPU, tiny sizes), makes ``correct``
come out false; the run without it is correct.

The cells run on one chip, so the fault "the exchange between chips left
out" has nowhere to live in them, and the grid cell solves one pair a
call, so it has no batch to leave half of.
"""

from __future__ import annotations

import json

import pytest
import torch

from conftest import run_tiny


def _correct(root, cell) -> bool:
    rc, out, _ = run_tiny(root, cell)
    assert rc == 0
    return json.loads(out[-1])["correct"]


@pytest.fixture
def solver_call(monkeypatch):
    """Replace ``BatchedSolver.__call__`` by ``fault(original, self,
    params)``."""
    from nodal_tpu_torch import batch

    original = batch.BatchedSolver.__call__

    def plant(fault):
        monkeypatch.setattr(batch.BatchedSolver, "__call__",
                            lambda self, p: fault(original, self, p))
    return plant


def test_sweep_sound(tiny_root):
    assert _correct(tiny_root, "tiny_mesh.tiny")


def test_sweep_state_unchanged(tiny_root, solver_call):
    """Every call returns the first call's answer: a state never
    stepped."""
    first = {}

    def stuck(original, self, p):
        if "x" not in first:
            first["x"] = original(self, p)
        return first["x"].clone()
    solver_call(stuck)
    assert not _correct(tiny_root, "tiny_mesh.tiny")


def test_sweep_half_batch_left_out(tiny_root, solver_call):
    def half(original, self, p):
        h = p.shape[0] // 2
        x = original(self, p[:h])
        return torch.cat([x, x.mean(0, keepdim=True).expand(
            p.shape[0] - h, -1)])
    solver_call(half)
    assert not _correct(tiny_root, "tiny_mesh.tiny")


def test_sweep_answer_altered(tiny_root, solver_call):
    def altered(original, self, p):
        x = original(self, p)
        x[-1, x.shape[1] // 2] *= 1 + 1e-4
        return x
    solver_call(altered)
    assert not _correct(tiny_root, "tiny_mesh.tiny")


def test_grid_sound(tiny_root):
    assert _correct(tiny_root, "tiny_grid.knight")


def test_grid_state_unchanged(tiny_root, monkeypatch):
    """CG hands back its starting iterate."""
    from nodal_tpu_torch.ops import grid

    def stuck(matvec, b, x0=None, **kw):
        x, info = cg(matvec, b, x0, **kw)
        return torch.zeros_like(b), info
    cg = grid.cg
    monkeypatch.setattr(grid, "cg", stuck)
    assert not _correct(tiny_root, "tiny_grid.knight")


def test_grid_answer_altered(tiny_root, monkeypatch):
    from nodal_tpu_torch.ops import grid

    original = grid.grid_equivalent_resistance

    def altered(*args, **kw):
        R, info = original(*args, **kw)
        return R * (1 + 1e-3), info
    monkeypatch.setattr(grid, "grid_equivalent_resistance", altered)
    assert not _correct(tiny_root, "tiny_grid.knight")


def test_grid_stops_short_of_its_tolerance(tiny_root, monkeypatch):
    """CG stops at 30 times the stated tolerance and says so in its
    residual; R alone may still pass its limit."""
    from nodal_tpu_torch.ops import grid

    def loose(matvec, b, x0=None, *, tol, **kw):
        return cg(matvec, b, x0, tol=30 * tol, **kw)
    cg = grid.cg
    monkeypatch.setattr(grid, "cg", loose)
    rc, out, _ = run_tiny(tiny_root, "tiny_grid.knight")
    compared = json.loads(out[-1])["compared"]
    assert compared["max_residual_over_tol"]["value"] > 1
    assert not json.loads(out[-1])["correct"]
