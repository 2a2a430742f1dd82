"""The block-Thomas elimination kept once a contract run on the CPU: the
plain factor-then-substitute of ``ops/band.py`` against the plain solve,
the ``band`` tier's prepared operator (first ``resolve`` eliminates and
keeps S_t⁻¹ and C_t, later ones substitute) against the operator that
eliminates for every solve, its counters, and the held-bytes cap.  The
card's kernels are held to the same in ``test_torch_chip_kernels.py``."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nodal_tpu_torch import BatchedSolver, Circuit, Netlist  # noqa: E402
from nodal_tpu_torch import batch as tbatch  # noqa: E402
from nodal_tpu_torch.ops import block_thomas  # noqa: E402
from nodal_tpu_torch.ops.band import (  # noqa: E402
    band_plan, band_thomas_factor, band_thomas_solve, band_thomas_substitute)
from nodal_tpu_torch.utils import tracing  # noqa: E402
from nodal_tpu_torch.utils.gridgen import (  # noqa: E402
    grid_rows, weighted_lattice_rows)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (beside other test
    processes the default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_band(B, nb, kb, r, dtype, seed):
    """Diagonally dominant block bands W [B, nb, kb, 3kb] (L_0 and
    U_{nb−1} zero, as plans give) and two right-hand sides' sets R
    [B, nb·kb, r] (a vector [B, nb·kb] for r = None)."""
    gen = torch.Generator().manual_seed(seed)
    W = 0.1 * torch.randn(B, nb, kb, 3 * kb, generator=gen, dtype=dtype)
    W[:, 0, :, :kb] = 0.0
    W[:, -1, :, 2 * kb:] = 0.0
    i = torch.arange(kb)
    W[:, :, i, kb + i] = W.abs().sum(-1)[:, :, i] + 1.0
    shape = (B, nb * kb) if r is None else (B, nb * kb, r)
    return (W, torch.randn(shape, generator=gen, dtype=dtype),
            torch.randn(shape, generator=gen, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,nb,kb,r", [
    (4, 5, 128, 1), (3, 4, 128, 3), (2, 1, 128, 1), (5, 16, 128, None),
    (2, 3, 256, 2), (2, 2, 384, 1)], ids=lambda v: str(v))
def test_plain_factor_then_substitute_is_the_plain_solve(B, nb, kb, r,
                                                         dtype):
    """The kept elimination's first answer is ``band_thomas_solve``'s, and
    a substitution for other right-hand sides is the plain solve of them:
    bit for bit, so within 1e-13 (f64) and 1e-5 (f32) relative too."""
    W, R1, R2 = _random_band(B, nb, kb, r, dtype, seed=26)
    x1, f = band_thomas_factor(W, R1)
    assert torch.equal(x1, band_thomas_solve(W, R1))
    want = band_thomas_solve(W, R2)
    got = band_thomas_substitute(f, R2)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(band_thomas_substitute(f, R2), got)  # f unchanged


@functools.cache
def _sweep(rows_key):
    """(stamps, f32 params [4, n_components], an f64 natural-order RHS
    [4, n]) of a band circuit, 5 % component spread."""
    rows = {"mesh": list(grid_rows(9, 40, (0, 0), (8, 39))),
            "lattice": list(weighted_lattice_rows(
                np.ones((12, 14, 13)), np.ones((12, 13, 14)),
                np.ones((11, 14, 14)), (0, 0, 0), (11, 13, 13)))}[rows_key]
    stamps = Circuit(Netlist.from_rows(
        rows + [["src", "A", "1", "1", "g"]])).stamps
    rng = np.random.default_rng(26)
    base = stamps.params
    params = base * (1.0 + 0.05 * rng.standard_normal((4, len(base))))
    return (stamps, torch.as_tensor(params, dtype=torch.float32),
            torch.as_tensor(rng.standard_normal((4, stamps.n))))


def _traced(fn, *args):
    """``fn(*args)`` in a call record of its own: (result, record)."""
    tracing.enable()
    try:
        with tracing.root("check"):
            out = fn(*args)
    finally:
        tracing.disable()
    return out, tracing.recent(1)[0]


def _reeliminating(stamps, dtype):
    """The ``band`` operator that eliminates for every solve (the one
    before the elimination was kept)."""
    return tbatch._band_operator(stamps, band_plan(stamps),
                                 block_thomas.band_solve, dtype)


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["forward", "transposed"])
@pytest.mark.parametrize("refine", ["auto", True])
def test_band_operator_keeps_its_elimination(refine, transpose):
    """A contract run on the ``band`` tier eliminates once and substitutes
    for each defect pass: its answer is the re-eliminating operator's
    (bit for bit on the CPU, so within 1e-12), its raw first solve too,
    and the counters read one factorization and a substitution a pass."""
    stamps, params, rhs = _sweep("mesh")
    solver = BatchedSolver(stamps, method="band", refine=refine,
                           device="cpu")
    old = _reeliminating(stamps, torch.float32)
    if refine == "auto":
        policy = functools.partial(tbatch._escalating_solver, stamps)
    else:
        policy = functools.partial(tbatch._refined_solver, stamps,
                                   passes=old.passes)
    want_run = policy(old.prepare, transpose=transpose)
    args = (params, rhs) if transpose else (params,)
    got_run = solver._solve_rhs_t if transpose else solver
    got, call = _traced(got_run, *args)
    want, old_call = _traced(want_run, *args)
    assert torch.equal(got, want)
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())
    passes = call.counters["contract_passes"]
    assert passes >= 1 and old_call.counters["contract_passes"] == passes
    assert call.counters["thomas_factorizations"] == 1
    assert call.counters["thomas_substitutions"] == passes
    assert len(call.find("thomas.solve")) == 1 + passes
    assert old_call.counters["thomas_factorizations"] == 1 + passes
    assert "thomas_substitutions" not in old_call.counters
    raw = solver._operator.prepare(params)(rhs if transpose else None)
    assert torch.equal(raw, old.prepare(params)(rhs if transpose else None))


def test_raw_band_solve_is_unchanged():
    """``refine=False``: one solve a call, the first ``resolve``, equal to
    the re-eliminating operator's bit for bit in f32 and f64."""
    stamps, params, _ = _sweep("mesh")
    for dtype in (torch.float32, torch.float64):
        solver = BatchedSolver(stamps, method="band", dtype=dtype,
                               refine=False, device="cpu")
        got, call = _traced(solver, params.to(dtype))
        want = _reeliminating(stamps, dtype).prepare(params.to(dtype))()
        assert torch.equal(got, want)
        assert call.counters["thomas_factorizations"] == 1
        assert "thomas_substitutions" not in call.counters


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["forward", "transposed"])
def test_raw_band_call_keeps_nothing(transpose, monkeypatch):
    """A raw call solves once, so it takes the operator's ``once`` form,
    which never calls ``band_factor`` (nothing kept to be thrown away);
    under ``"auto"`` the f32 operator's first ``resolve`` does."""
    stamps, params, rhs = _sweep("mesh")
    kept = []

    def factor(W, R):
        kept.append(W.shape)
        return block_thomas.band_factor(W, R)

    monkeypatch.setattr(tbatch, "band_factor", factor)
    for dtype, refine in ((torch.float32, False), (torch.float64, "auto"),
                          (torch.float64, False)):
        solver = BatchedSolver(stamps, method="band", dtype=dtype,
                               refine=refine, device="cpu")
        if transpose:
            got = solver._solve_rhs_t(params.to(dtype), rhs.to(dtype))
        else:
            got = solver(params.to(dtype))
        assert got.dtype == dtype and not kept
    BatchedSolver(stamps, method="band", device="cpu")(params)
    assert len(kept) == 1


def test_sband_operator_counts_no_thomas():
    stamps, params, _ = _sweep("mesh")
    solver = BatchedSolver(stamps, method="sband", device="cpu")
    _, call = _traced(solver, params)
    assert call.counters["contract_passes"] >= 1
    assert call.counters.get("thomas_factorizations", 0) == 0
    assert call.counters.get("thomas_substitutions", 0) == 0


@pytest.mark.parametrize("case", ["cap", "kb256"])
def test_band_operator_eliminates_again_where_nothing_is_kept(case,
                                                              monkeypatch):
    """Above ``SCRATCH_BYTES_MAX`` (here lowered under the mesh's held bytes)
    and at kb > 128 the operator eliminates for every solve, as before,
    and the counters say so: a factorization a solve, no substitution;
    the answer is the re-eliminating operator's."""
    stamps, params, _ = _sweep("mesh" if case == "cap" else "lattice")
    plan = band_plan(stamps)
    held = block_thomas.held_elems(len(params), plan.nb, plan.kb, 1) * 4
    if case == "cap":
        assert plan.kb == 128
        monkeypatch.setattr(block_thomas, "SCRATCH_BYTES_MAX", held - 1)
    else:
        assert plan.kb == 256 and held <= block_thomas.SCRATCH_BYTES_MAX
    solver = BatchedSolver(stamps, method="band", device="cpu")
    got, call = _traced(solver, params)
    passes = call.counters["contract_passes"]
    assert call.counters["thomas_factorizations"] == 1 + passes
    assert "thomas_substitutions" not in call.counters
    want = tbatch._escalating_solver(
        stamps, _reeliminating(stamps, torch.float32).prepare)(params)
    assert torch.equal(got, want)


def test_band_factor_keeps_only_what_substitution_takes(monkeypatch):
    """``band_factor`` keeps the elimination at kb = 128, r <= ``APPLY_R``
    and within ``SCRATCH_BYTES_MAX``; else it is ``band_solve_multi``'s
    solve with nothing kept.  ``band_substitute`` refuses more right-hand
    sides than its launch takes."""
    W, R, R2 = _random_band(3, 4, 128, 1, torch.float64, seed=7)
    X, f = block_thomas.band_factor(W, R)
    assert f is not None and f.r == 1
    assert torch.equal(X, band_thomas_solve(W, R))
    assert torch.equal(block_thomas.band_substitute(f, R2),
                       band_thomas_solve(W, R2))
    with pytest.raises(ValueError):
        block_thomas.band_substitute(f, R2.expand(-1, -1, 5).contiguous())
    W5, R5, _ = _random_band(3, 4, 128, 5, torch.float64, seed=8)
    X5, f5 = block_thomas.band_factor(W5, R5)
    assert f5 is None and torch.equal(X5, band_thomas_solve(W5, R5))
    monkeypatch.setattr(block_thomas, "SCRATCH_BYTES_MAX",
                        block_thomas.held_elems(3, 4, 128, 1) * 8 - 1)
    assert block_thomas.band_factor(W, R)[1] is None


@pytest.mark.parametrize("B,nb,kb,r", [
    (1024, 16, 128, 1), (1, 79, 128, 4), (7, 3, 128, 2)])
def test_held_layout(B, nb, kb, r):
    """``held_elems``: S_t⁻¹ a block row, the rhs scratch and the slots of
    ``launch_plan`` (rows padded to 4 values); the lattice's B 1024 keeps
    ~2.2 GB in f32, within ``SCRATCH_BYTES_MAX``."""
    plan = block_thomas.launch_plan(B, nb, kb, r, 4)
    per_loop = plan.scratch_elems // plan.chunk
    assert block_thomas.held_elems(B, nb, kb, r) == B * (
        per_loop + (nb - 1) * kb * kb)
    if (B, nb) == (1024, 16):
        held = block_thomas.held_elems(B, nb, kb, r) * 4
        assert 2.1e9 < held < 2.3e9 <= block_thomas.SCRATCH_BYTES_MAX


def test_kernels_are_built_with_the_library():
    from nodal_tpu_torch.utils import kernels

    src = (kernels.CSRC_DIR / "block_thomas.cu").read_text()
    for name, nargs in (("block_thomas_factor", 9), ("block_thomas_subst",
                                                     11)):
        for suffix in ("f32", "f64"):
            argtypes, _ = kernels._SIGNATURES[f"{name}_{suffix}"]
            assert len(argtypes) == nargs
            assert f"int {name}_{suffix}(" in src
    assert "block_thomas_subst(SubstArgs<T> a)" in src
