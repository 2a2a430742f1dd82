"""The port's skyline LDLᵀ (``nodal_tpu_torch/ops/skyline.py`` over its copy
``nodal_tpu_torch/cpp/skyline.cpp``) against the JAX package's
(``nodal_tpu/ops/skyline.py``) and scipy: plans array for array, factors
and solves within 1e-12 of the JAX package's and 1e-10 of ``spsolve``,
``None`` on a non-SPD pivot and over the caps, and the library built into
the package's own ``_build/`` directory, never a shared temporary one.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

torch = pytest.importorskip("torch")

from nodal_tpu.ops import skyline as jskyline  # noqa: E402
from nodal_tpu_torch.ops import skyline  # noqa: E402
from nodal_tpu_torch.utils import kernels  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _built():
    """The skyline's library, built once (not while the module imports)."""
    if not skyline.available():
        pytest.skip("the skyline library does not build here (g++)")


def _laplacian(h, w, seed=0):
    """A grounded h×w mesh of random conductances as COO (duplicates
    summed by the factor), every 7th node tied to ground."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []

    def add(a, b, g):
        rows.extend([a, b, a, b])
        cols.extend([a, b, b, a])
        vals.extend([g, g, -g, -g])

    for i in range(h):
        for j in range(w):
            k = i * w + j
            if j + 1 < w:
                add(k, k + 1, rng.uniform(0.5, 2.0))
            if i + 1 < h:
                add(k, k + w, rng.uniform(0.5, 2.0))
            if k % 7 == 0:
                rows.append(k)
                cols.append(k)
                vals.append(rng.uniform(0.5, 2.0))
    return h * w, np.array(rows), np.array(cols), np.array(vals)


def _random_graph(n, m, seed):
    """A connected random resistive graph (a ring plus chords), grounded at
    every 50th node: an irregular profile."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.arange(n), rng.integers(0, n, m)])
    b = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, m)])
    keep = a != b
    a, b = a[keep], b[keep]
    g = rng.uniform(0.5, 2.0, len(a))
    t = np.arange(0, n, 50)
    rows = np.concatenate([a, b, a, b, t])
    cols = np.concatenate([a, b, b, a, t])
    vals = np.concatenate([g, g, -g, -g, np.ones(len(t))])
    return n, rows, cols, vals


CASES = {"mesh": lambda: _laplacian(13, 17, seed=1),
         "graph": lambda: _random_graph(600, 900, seed=2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_matches_jax(case):
    n, rows, cols, _ = CASES[case]()
    plan = skyline.plan_skyline(n, rows, cols)
    jplan = jskyline.plan_skyline(n, rows, cols)
    for f in ("perm", "iperm", "jmin", "rowptr"):
        got, want = getattr(plan, f), getattr(jplan, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (plan.n, plan.profile_nnz, plan.factor_flops) == \
        (jplan.n, jplan.profile_nnz, jplan.factor_flops)


@pytest.mark.parametrize("case", sorted(CASES))
def test_factor_solve_matches_jax_and_scipy(case):
    n, rows, cols, vals = CASES[case]()
    fact = skyline.factor(skyline.plan_skyline(n, rows, cols), rows, cols,
                          vals)
    jfact = jskyline.factor(jskyline.plan_skyline(n, rows, cols), rows,
                            cols, vals)
    np.testing.assert_array_equal(fact.diag, jfact.diag)
    np.testing.assert_array_equal(fact.sky, jfact.sky)
    B = np.random.default_rng(3).standard_normal((5, n))
    X = skyline.solve(fact, B)
    np.testing.assert_allclose(X, jskyline.solve(jfact, B), rtol=0,
                               atol=1e-12 * np.abs(X).max())
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    ref = spla.spsolve(A, B.T).T
    assert np.abs(X - ref).max() / np.abs(ref).max() < 1e-10
    np.testing.assert_allclose(skyline.solve(fact, B[0]), X[0])


def test_blocked_solve_past_one_block():
    """Forty right-hand sides take one full block of 32 and a partial one
    of 8 (``sk_solve_blocked``): each equals its single solve."""
    n, rows, cols, vals = _laplacian(9, 11, seed=4)
    fact = skyline.factor(skyline.plan_skyline(n, rows, cols), rows, cols,
                          vals)
    B = np.random.default_rng(5).standard_normal((40, n))
    X = skyline.solve(fact, B)
    for i in (0, 31, 32, 39):
        np.testing.assert_allclose(X[i], skyline.solve(fact, B[i]),
                                   rtol=1e-13, atol=1e-13)


def test_non_spd_pivot_returns_none():
    n, rows, cols, vals = _laplacian(6, 6, seed=3)
    rows, cols = np.append(rows, 8), np.append(cols, 8)
    vals = np.append(vals, -100.0)
    for mod in (skyline, jskyline):
        plan = mod.plan_skyline(n, rows, cols)
        assert mod.factor(plan, rows, cols, vals) is None


def test_profile_caps_reject():
    n, rows, cols, _ = _laplacian(10, 10)
    for mod in (skyline, jskyline):
        assert mod.plan_skyline(n, rows, cols, max_nnz=10) is None
        assert mod.plan_skyline(n, rows, cols, max_flops=10.0) is None
        assert mod.plan_skyline(n, rows, cols) is not None


def test_empty_plan():
    plan = skyline.plan_skyline(0, np.zeros(0, int), np.zeros(0, int))
    assert plan.n == 0 and plan.profile_nnz == 0


def test_library_lands_in_the_private_build_dir():
    lib = skyline._load()
    path = kernels.host_library_path(kernels.CPP_DIR / "skyline.cpp",
                                     skyline.FLAGS)
    assert path.parent == kernels.BUILD_DIR
    assert path.exists() and path.name.startswith("libskyline_")
    assert lib._name == str(path)
    assert "nodal_tpu_native" not in lib._name


def test_host_build_is_keyed_and_atomic(tmp_path, monkeypatch):
    """A new source or new flags build a new library; the build writes a
    temporary file in the private directory and renames it; a failed
    build raises with the compiler's output and leaves nothing."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int probe() { return 7; }\n')
    flags = ("-O1", "-shared", "-fPIC")
    out = kernels.build_host_library(src, flags)
    assert out.parent == tmp_path / "_build" and out.exists()
    assert oct(out.parent.stat().st_mode & 0o777) == "0o700"
    import ctypes

    assert ctypes.CDLL(str(out)).probe() == 7
    assert kernels.build_host_library(src, flags) == out
    assert kernels.host_library_path(src, ("-O2",) + flags[1:]) != out
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building "
                       "probe.cpp"):
        kernels.build_host_library(src, flags)
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == \
        [out.name]
