"""The port's unbanded tiers against the JAX package: padded dense assembly,
the plain no-pivot blocked LU (also against the Pallas LU kernels in
interpret mode), the schur tier's dense block assembler, the CPU side of
the CUDA LU kernel's wrapper and its build, and ``BatchedSolver`` with the
``block`` and ``dense`` tiers end to end.

Tolerances: f64 assembly exact; the plain f64 solver 1e-12 relative (the
same panels, the products summed in another order); the plain f32 solver
against the Pallas kernels within the bounds of the JAX package's own
tests of them (5e-6 for one right-hand side, 5e-5 for several, both
against numpy f64); the raw f32 tiers 1e-5 from the JAX package, or twice
the JAX package's own error from numpy f64 where the conditioning puts
each f32 answer further than that from the truth (κ·ε₃₂ ≈ 1e-4 on the
sparsely grounded network); the f64 tiers 1e-9 from the JAX package and
1e-6 (the contract) from numpy f64 dense solves.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nodal_tpu import Circuit as JCircuit  # noqa: E402
from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu import batch as jbatch  # noqa: E402
from nodal_tpu.ops import block_lu as jblu  # noqa: E402
from nodal_tpu.ops import pallas_block_lu as jplu  # noqa: E402
from nodal_tpu.ops.assemble import assemble_dense as jassemble_dense  # noqa: E402
from nodal_tpu_torch import BatchedSolver  # noqa: E402
from nodal_tpu_torch import batch as tbatch  # noqa: E402
from nodal_tpu_torch.models.stamps import stamps_from_reference  # noqa: E402
from nodal_tpu_torch.ops import block_lu, lu  # noqa: E402
from nodal_tpu_torch.ops.assemble import assemble_dense  # noqa: E402
from nodal_tpu_torch.utils import kernels  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows, ladder_rows  # noqa: E402

B = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_graph_rows(n, edges, seed, tie_every=1, extra=()):
    """Random unit resistors between node pairs, a ground tie on every
    ``tie_every``-th node: no band for RCM to find."""
    rng = np.random.default_rng(seed)
    rows = [["v", "A", "1", "n0", "g"]]
    for k in range(edges):
        a, b = rng.integers(0, n, 2)
        if a != b:
            rows.append([f"r{k}", "R", "1", f"n{a}", f"n{b}"])
    return rows + [[f"rg{j}", "R", "1", f"n{j}", "g"]
                   for j in range(0, n, tie_every)] + [list(r) for r in extra]


def _mesh_with_branches():
    """The JAX package's dense-method test circuit: an 8×8 mesh with a
    voltage source, a VCCS and a CCCS."""
    return list(grid_rows(8, 8, (0, 0), (7, 7))) + [
        ["e1", "E", "2", "1", "g"],
        ["d1", "VCCS", "0.5", "n0_3", "g", "1", "g"],
        ["f1", "CCCS", "1.5", "n3_3", "g", "1", "g", "e1"]]


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _stamps(rows):
    jc = JCircuit(JNetlist.from_rows(rows))
    return jc, stamps_from_reference(jc.stamps)


def _params(jc, n, seed):
    base = jc.stamps.params
    rng = np.random.default_rng(seed)
    return (base * (1.0 + 0.05 * rng.standard_normal((n, len(base))))
            ).astype(np.float32).astype(np.float64)


def _dense_f64(jc, params, rhs=None, transpose=False):
    out = []
    for k, p in enumerate(params):
        G, b = jassemble_dense(jc.stamps, jnp.asarray(p), dtype=jnp.float64)
        G = np.asarray(G).T if transpose else np.asarray(G)
        out.append(np.linalg.solve(G, np.asarray(b) if rhs is None
                                   else rhs[k]))
    return np.stack(out)


def _dominant(n, batch, r, seed, dtype=np.float64):
    """Diagonally dominant symmetric matrices, as the JAX package's
    dense-method tests make them."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, n, n)) * 0.5
    A = A + np.transpose(A, (0, 2, 1))
    A += np.eye(n)[None] * (np.abs(A).sum(-1).max(-1)[:, None, None] + 1.0)
    R = rng.standard_normal((batch, n, r))
    return A.astype(dtype), R.astype(dtype)


# --- assembly -------------------------------------------------------------

ASSEMBLY_CASES = {
    "randnet": _random_graph_rows(200, 800, seed=3, tie_every=50),
    "mesh_with_branches": _mesh_with_branches(),
}


@pytest.mark.parametrize("case", list(ASSEMBLY_CASES))
@pytest.mark.parametrize("pad", [False, True])
def test_assemble_dense_matches_reference_exactly(case, pad):
    jc, st = _stamps(ASSEMBLY_CASES[case])
    params = _params(jc, B, seed=1)
    m = -(-st.n // 128) * 128 if pad else None
    assert not pad or m > st.n
    with jax.enable_x64(True):
        jG, jb = jax.vmap(lambda p: jassemble_dense(
            jc.stamps, p, dtype=jnp.float64, pad_to=m))(jnp.asarray(params))
    G, b = assemble_dense(st, torch.as_tensor(params), dtype=torch.float64,
                          pad_to=m)
    assert G.dtype == torch.float64 and G.shape == jG.shape
    np.testing.assert_array_equal(G.numpy(), np.asarray(jG))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_assemble_dense_refuses_a_smaller_pad():
    _, st = _stamps(ASSEMBLY_CASES["randnet"])
    with pytest.raises(ValueError, match="pad_to"):
        assemble_dense(st, torch.as_tensor(st.params[None]), pad_to=st.n - 1)


def test_schur_block_assembler_matches_reference_exactly():
    jc, st = _stamps(_mesh_with_branches())
    nk, kbe = st.n_kcl, st.n - st.n_kcl
    nk_pad = jplu._pad(nk)
    params = _params(jc, B, seed=2)
    with jax.enable_x64(True):
        want = jax.vmap(jbatch._schur_block_assembler(
            jc.stamps, jnp.float64, nk_pad))(jnp.asarray(params))
    A, Bm, C, D, bk, bb = tbatch._schur_block_assembler(
        st, torch.float64, nk_pad)(torch.as_tensor(params))
    assert A.shape == (B, nk_pad, nk_pad) and A.dtype == torch.float64
    np.testing.assert_array_equal(A.numpy(), np.asarray(want[0]))
    # The port keeps Bm, C and bk padded to nk_pad, the LU's layout.
    for got, w, axis in ((Bm, want[1], 1), (C, want[2], 2), (bk, want[4], 1)):
        assert got.shape[axis] == nk_pad
        np.testing.assert_array_equal(got.narrow(axis, 0, nk).numpy(),
                                      np.asarray(w))
        assert not got.narrow(axis, nk, nk_pad - nk).any()
    np.testing.assert_array_equal(D.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(bb.numpy(), np.asarray(want[5]))


# --- the plain solver -----------------------------------------------------

@pytest.mark.parametrize("n", [128, 300])
def test_blocked_solve_matches_reference(n):
    A, R = _dominant(n, 2, 1, seed=n)
    b = R[..., 0]
    want = np.asarray(jblu.blocked_solve(jnp.asarray(A), jnp.asarray(b)))
    got = block_lu.blocked_solve(torch.as_tensor(A), torch.as_tensor(b))
    assert got.shape == (2, n)
    assert _rel(got.numpy(), want) <= 1e-12
    assert _rel(got.numpy(), np.linalg.solve(A, b[..., None])[..., 0]) \
        <= 1e-12


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_blocked_factor_and_solve_match_reference(rhs):
    A, R = _dominant(384, 2, 5, seed=7)
    if rhs == "vector":
        R = R[..., 0]
    jpanels = jblu.blocked_factor(jnp.asarray(A))
    panels = block_lu.blocked_factor(torch.as_tensor(A))
    assert len(panels) == len(jpanels) == 3
    for got, want in zip(panels, jpanels):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert g.numel() == 0 or _rel(g.numpy(), w) <= 1e-12
    want = np.asarray(jblu.blocked_solve_factored(jpanels, jnp.asarray(R)))
    got = block_lu.blocked_solve_factored(panels, torch.as_tensor(R))
    assert got.shape == R.shape
    assert _rel(got.numpy(), want) <= 1e-12


def test_blocked_factor_refuses_unpadded_input():
    with pytest.raises(ValueError, match="multiple of 128"):
        block_lu.blocked_factor(torch.eye(100, dtype=torch.float64))


def test_schur_solve_matches_reference():
    jc, st = _stamps(_mesh_with_branches())
    params = _params(jc, B, seed=3)
    G, b = assemble_dense(st, torch.as_tensor(params), dtype=torch.float64)
    with jax.enable_x64(True):
        want = np.asarray(jblu.schur_solve(jnp.asarray(G.numpy()),
                                           jnp.asarray(b.numpy()), st.n_kcl))
    got = block_lu.schur_solve(G, b, st.n_kcl)
    assert got.shape == (B, st.n)
    assert _rel(got.numpy(), want) <= 1e-12
    assert _rel(got.numpy(), _dense_f64(jc, params)) <= 1e-12
    with pytest.raises(ValueError, match="branch equations"):
        block_lu.schur_solve(G, b, st.n)


def test_plain_solver_matches_pallas_kernel():
    A, R = _dominant(256, 3, 1, seed=256, dtype=np.float32)
    b = R[..., 0]
    want = np.asarray(jplu.pallas_lu_solve(jnp.asarray(A), jnp.asarray(b)))
    got = block_lu.blocked_solve(torch.as_tensor(A), torch.as_tensor(b))
    exact = np.linalg.solve(A.astype(np.float64),
                            b[..., None].astype(np.float64))[..., 0]
    assert _rel(want, exact) < 5e-6
    assert _rel(got.numpy(), exact) < 5e-6
    assert _rel(got.numpy(), want) < 5e-6


def test_plain_solver_matches_pallas_multi_kernel():
    A, R = _dominant(256, 3, 5, seed=7, dtype=np.float32)
    want = np.asarray(jplu.pallas_lu_solve_multi(jnp.asarray(A),
                                                 jnp.asarray(R)))
    got = lu.lu_solve_multi(torch.as_tensor(A), torch.as_tensor(R))
    exact = np.linalg.solve(A.astype(np.float64), R.astype(np.float64))
    assert _rel(want, exact) < 5e-5
    assert _rel(got.numpy(), exact) < 5e-5
    assert _rel(got.numpy(), want) < 5e-5


# --- the CUDA kernels' order of operations, emulated on the CPU --------------
#
# block_lu.cu (through csrc/dense_tile.cuh) inverts each 128×128 diagonal
# block by Gauss-Jordan in four 32-column panels (each 32×32 pivot block
# element by element), sums every tile product apart from zero and adds it
# to the value it updates last.  Summed onto the Schur complement step by
# step instead, the f32 error grew to 20× the plain version's on sparsely
# grounded networks; these emulations catch such a drift before a chip run.

def _gauss_jordan(D):
    """In-place Gauss-Jordan without pivoting, element by element (the
    kernel's 32×32 pivot blocks)."""
    a = D.clone()
    for k in range(a.shape[-1]):
        p = 1.0 / a[..., k, k]
        col, row = a[..., :, k].clone(), a[..., k, :].clone()
        a = a - (col * p[..., None])[..., :, None] * row[..., None, :]
        a[..., k, :] = row * p[..., None]
        a[..., :, k] = -col * p[..., None]
        a[..., k, k] = p
    return a


def _panel_gauss_jordan(D, panel=32):
    """The kernel's 128×128 inverse: Gauss-Jordan in 32-column panels, the
    rank-32 updates summed apart."""
    M = D.clone()
    for p0 in range(0, M.shape[-1], panel):
        P = slice(p0, p0 + panel)
        Dp = _gauss_jordan(M[..., P, P])
        rowp = Dp @ M[..., P, :]
        rowp[..., :, P] = Dp
        upd = M[..., :, P] @ rowp
        new = M - upd
        new[..., :, P] = -upd[..., :, P]
        new[..., P, :] = rowp
        M = new
    return M


def _emulated_factor(G, k=128):
    """The packed factor block_lu.cu leaves in place of G: panels in pairs
    (t, t + 1), whose updates of the rest are delayed into one product of
    depth 256, a lone panel before the last alone."""
    F = G.clone()
    n = F.shape[-1]
    d = 0
    while d < n:
        e = d + k
        F[..., d:e, d:e] = _panel_gauss_jordan(F[..., d:e, d:e])
        if e == n:
            break
        if e + k == n:
            P = F[..., d:e, d:e] @ F[..., d:e, e:]
            F[..., e:, e:] = F[..., e:, e:] + (-1.0) * (F[..., e:, d:e] @ P)
            d = e
            continue
        f = e + k
        Pa = F[..., d:e, d:e] @ F[..., d:e, e:f]
        Pb = F[..., d:e, d:e] @ F[..., d:e, f:]
        F[..., e:, e:f] = F[..., e:, e:f] + (-1.0) * (F[..., e:, d:e] @ Pa)
        F[..., e:f, f:] = F[..., e:f, f:] + (-1.0) * (F[..., e:f, d:e] @ Pb)
        F[..., e:f, e:f] = _panel_gauss_jordan(F[..., e:f, e:f])
        Pc = F[..., e:f, e:f] @ F[..., e:f, f:]
        F[..., f:, f:] = F[..., f:, f:] + (-1.0) * (
            F[..., f:, d:f] @ torch.cat([Pb, Pc], dim=-2))
        d = f
    return F


def _emulated_solve(F, R, block=128):
    """block_lu.cu's two sweeps with the packed factor."""
    X = R.clone()
    n = F.shape[-1]
    for d in range(0, n - block, block):
        e = d + block
        z = F[..., d:e, d:e] @ X[..., d:e, :]
        X[..., e:, :] = X[..., e:, :] + (-1.0) * (F[..., e:, d:e] @ z)
    for d in range(n - block, -1, -block):
        e = d + block
        z = X[..., d:e, :] + (-1.0) * (F[..., d:e, e:] @ X[..., e:, :])
        X[..., d:e, :] = F[..., d:e, d:e] @ z
    return X


def _laplacian_system(n, edges, tie_every, batch, seed):
    """A grounded random-graph Laplacian assembled dense and padded to 128,
    f64, with its right-hand side."""
    jc, st = _stamps(_random_graph_rows(n, edges, seed, tie_every))
    G, b = assemble_dense(st, torch.as_tensor(_params(jc, batch, seed)),
                          dtype=torch.float64, pad_to=-(-st.n // 128) * 128)
    return G.numpy(), b.numpy()[..., None]


#: Systems held against the JAX package: the chip smoke's class (a tie on
#: every 50th node, κ ≈ 1e3) at 5 panels and at one, and the diagonally
#: dominant class at 3 panels with 3 right-hand sides.
EMULATION_CASES = {
    "laplacian_n600": lambda: _laplacian_system(600, 2400, 50, 2, 0),
    "laplacian_n100": lambda: _laplacian_system(100, 400, 50, 2, 1),
    "dominant_n384_r3": lambda: _dominant(384, 2, 3, seed=11),
}


@pytest.mark.parametrize("n", [128, 256, 384, 512, 1024])
def test_factor_plan(n):
    """The factorization's scratch and launches (ops/lu.py mirrors the
    panel loop of csrc/dense_tile.cuh): a pair of panels needs 128·128 +
    256·(n − 256) values and 8 launches, a lone panel 128·(n − 128) and
    3, the last panel's inverse 1."""
    q = n // 128
    pairs = (q - 1) // 2
    lone = (q - 1) % 2
    assert lu.factor_launches(n) == 8 * pairs + 3 * lone + 1
    want = 128 * (n - 128) if n <= 256 else 128 * 128 + 256 * (n - 256)
    assert lu.factor_scratch(n) == want


@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_emulated_kernel_order_matches_reference(case):
    """The kernels' order of operations in f32 stays near the f64 truth:
    within 8× the JAX package's own f32 blocked solve's error, or 1e-6
    where both are at the f32 rounding floor.  The two differ in the
    diagonal inverses (no-pivot Gauss-Jordan against LAPACK's pivoted
    inverse, 1.4–5.5× on these systems; element-by-element Gauss-Jordan
    over the whole block, the earlier kernel's, is 2.2–11×) and in the
    order of each product's sums; summing onto the Schur complement once
    cost 20×.
    In f64 the emulation agrees with the JAX package to 1e-10 (κ·ε₆₄ with
    growth)."""
    A, R = EMULATION_CASES[case]()
    truth = np.linalg.solve(A, R)
    A32 = torch.as_tensor(A, dtype=torch.float32)
    got = _emulated_solve(_emulated_factor(A32),
                          torch.as_tensor(R, dtype=torch.float32)).numpy()
    want = np.asarray(jblu.blocked_solve_factored(
        jblu.blocked_factor(jnp.asarray(A, jnp.float32)),
        jnp.asarray(R, jnp.float32)))
    assert _rel(got, truth) <= max(8 * _rel(want, truth), 1e-6)
    got64 = _emulated_solve(_emulated_factor(torch.as_tensor(A)),
                            torch.as_tensor(R)).numpy()
    with jax.enable_x64(True):
        want64 = np.asarray(jblu.blocked_solve_factored(
            jblu.blocked_factor(jnp.asarray(A)), jnp.asarray(R)))
    assert _rel(got64, want64) <= 1e-10 and _rel(got64, truth) <= 1e-10


def test_emulated_inverse_is_the_inverse():
    """The panel Gauss-Jordan inverse of a 128×128 block, f64, against
    numpy's: the same matrix, rounded apart (1e-12 on κ of a few)."""
    A, _ = _dominant(128, 3, 1, seed=5)
    got = _panel_gauss_jordan(torch.as_tensor(A)).numpy()
    assert _rel(got, np.linalg.inv(A)) <= 1e-12


# --- the CUDA kernel's wrapper, CPU side ------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 3, 130])
def test_wrapper_on_cpu_is_the_plain_version(dtype, r):
    A, R = _dominant(256, 2, r, seed=r)
    A, R = torch.as_tensor(A).to(dtype), torch.as_tensor(R).to(dtype)
    A0 = A.clone()
    before = (lu.lu_factor.launches, lu.lu_solve_factored.launches)
    F = lu.lu_factor(A)
    assert torch.equal(A, A0)  # the plain factorization is not in place
    got = lu.lu_solve_factored(F, R)
    want = block_lu.blocked_solve_factored(block_lu.blocked_factor(A0), R)
    assert torch.equal(got, want)
    assert torch.equal(lu.lu_solve_multi(A, R), want)
    x = lu.lu_solve(A, R[..., 0])
    assert torch.equal(x, block_lu.blocked_solve(A0, R[..., 0]))
    assert torch.equal(lu.lu_solve(A, R[..., 0], n_valid=200), x[:, :200])
    assert (lu.lu_factor.launches, lu.lu_solve_factored.launches) == \
        before == (0, 0)
    assert lu.lu_solve_factored.last_shape is None


@pytest.mark.parametrize("bad", ["rank", "square", "unpadded", "empty",
                                 "batch", "rows", "dtype", "int", "no_rhs",
                                 "device"])
def test_wrapper_rejects_bad_input(bad):
    A, R = (torch.as_tensor(t) for t in _dominant(128, 2, 1, seed=1))
    if bad == "rank":
        A = A[0]
    elif bad == "square":
        A = A[:, :, :-1]
    elif bad == "unpadded":
        A, R = A[:, :100, :100], R[:, :100]
    elif bad == "empty":
        A, R = A[:, :0, :0], R[:, :0]
    elif bad == "batch":
        R = R[:1]
    elif bad == "rows":
        R = R[:, :-1]
    elif bad == "dtype":
        R = R.float()
    elif bad == "int":
        A, R = A.int(), R.int()
    elif bad == "no_rhs":
        R = R[..., :0]
    else:
        R = R.to("meta")
    with pytest.raises((ValueError, TypeError)):
        lu.lu_solve_multi(A, R)


def test_kernel_is_built_with_the_library():
    names = [p.name for p in kernels._sources()]
    assert "block_lu.cu" in names and "dense_tile.cuh" in names
    for name, n_args in (("block_lu_factor_f32", 5),
                         ("block_lu_factor_f64", 5),
                         ("block_lu_solve_f32", 7),
                         ("block_lu_solve_f64", 7)):
        argtypes, _ = kernels._SIGNATURES[name]
        assert len(argtypes) == n_args
    src = (kernels.CSRC_DIR / "block_lu.cu").read_text()
    for name in ("block_lu_factor_f32", "block_lu_factor_f64",
                 "block_lu_solve_f32", "block_lu_solve_f64"):
        assert f"int {name}(" in src
    # The shared tile core, under this source's own kernel names.
    assert '#include "dense_tile.cuh"' in src
    assert "DENSE_TILE_KERNELS(block_lu)" in src
    core = (kernels.CSRC_DIR / "dense_tile.cuh").read_text()
    assert f"kBlock = {lu.BLOCK}" in core and lu.BLOCK == 128
    # f64 products on the FP64 tensor cores; f32 in full f32 (no TF32).
    assert "mma.sync.aligned.m16n8k4.row.col.f64" in core
    assert "tf32" not in core.lower().replace("no tf32", "")
    assert "cp.async" in core


def test_loader_compiles_sources_and_hashes_headers(tmp_path, monkeypatch):
    """A ``.cuh`` header is hashed into the library's name and put on the
    include path, but only the ``.cu`` files reach nvcc as inputs: one
    compiler process a source, started together, then one link."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("#include \"common.cuh\"\n")
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    first = kernels.library_path()
    (csrc / "common.cuh").write_text("// v2\n")
    assert kernels.library_path() != first
    compiles, links = [], []

    def touch(cmd):
        with open(cmd[cmd.index("-o") + 1], "wb"):
            pass

    class FakePopen:
        def __init__(self, cmd, **kw):
            compiles.append(cmd)
            touch(cmd)
            self.returncode = 0

        def communicate(self):
            return "", ""

    def fake_run(cmd, **kw):
        links.append(cmd)
        touch(cmd)
        return type("P", (), {"returncode": 0, "stdout": "", "stderr": ""})

    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    built = kernels.build()
    assert built == kernels.library_path() and built.exists()
    assert [cmd[-1] for cmd in compiles] == [str(csrc / "a.cu"),
                                             str(csrc / "b.cu")]
    objs = []
    for cmd in compiles:
        assert cmd[cmd.index("-I") + 1] == str(csrc)
        assert "-c" in cmd and "-shared" not in cmd
        objs.append(cmd[cmd.index("-o") + 1])
    (link,) = links
    assert "-shared" in link
    assert link[link.index("-o") + 2:] == objs


# --- BatchedSolver: the block and dense tiers -------------------------------

OPMODEL_CSV = Path(__file__).resolve().parent.parent / "examples" / \
    "opmodel_amplifier.csv"

#: (rows or a netlist file, JAX method, batch).  ``random_graph`` is
#: test_torch_batch.py's RANDOM_GRAPH (a tie on every node); ``randnet`` the
#: chip smoke's class (a tie on every 50th node, κ ≈ 1e3).
SOLVER_CASES = {
    "random_graph": (_random_graph_rows(1200, 4800, seed=0), "block", 2),
    "randnet": (_random_graph_rows(600, 2400, seed=0, tie_every=50),
                "block", B),
    "ladder_with_source": (ladder_rows(8)[1:] + [["v0", "E", "1", "n0",
                                                  "g"]], "dense", B),
    "opmodel_amplifier": (OPMODEL_CSV, "dense", B),
}


@pytest.fixture(scope="module", params=list(SOLVER_CASES))
def case(request):
    """(JAX circuit, port stamps, params, numpy f64 solutions, JAX
    method)."""
    source, method, batch = SOLVER_CASES[request.param]
    netlist = JNetlist(str(source)) if isinstance(source, Path) else \
        JNetlist.from_rows(source)
    jc = JCircuit(netlist)
    params = _params(jc, batch, seed=5)
    return (jc, stamps_from_reference(jc.stamps), params,
            _dense_f64(jc, params), method)


def _raw_f32_tol(want, ref):
    """1e-5, or twice the JAX package's own distance from numpy f64 where
    conditioning puts each f32 answer further than that from the truth."""
    return max(1e-5, 2 * _rel(want, ref))


@pytest.mark.parametrize("refine", [False, "auto", True])
def test_solver_matches_reference(case, refine):
    jc, st, params, ref, method = case
    js = jbatch.BatchedSolver(jc, dtype=jnp.float32, refine=refine)
    ts = BatchedSolver(st, refine=refine, device="cpu")
    assert js.method == ts.method == method
    want = np.asarray(js(params))
    before = (lu.lu_factor.launches, lu.lu_solve_factored.launches)
    got = ts(params)
    # CPU tensors take the plain solvers: the kernel never launches.
    assert (lu.lu_factor.launches, lu.lu_solve_factored.launches) == \
        before == (0, 0)
    assert got.shape == (len(params), st.n)
    if refine is False:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= _raw_f32_tol(want, ref)
        return
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-9
    assert _rel(got.numpy(), ref) <= 1e-6
    res = ts.residuals(params, got)
    assert res.shape == (len(params),) and float(res.max()) <= 1e-6
    # The two audits sum the same f64 products in other orders: they agree
    # to ~ε·‖G‖·‖x‖ (‖G‖ ≈ 1e5 on the opamp macromodel's gain rows).
    G0, _ = jassemble_dense(jc.stamps, jnp.asarray(params[0]),
                            dtype=jnp.float64)
    atol = max(1e-12, 1e-15 * np.abs(np.asarray(G0)).max()
               * np.abs(ref).max())
    np.testing.assert_allclose(
        res.numpy(), np.asarray(js.residuals(params, got.numpy())),
        rtol=0, atol=atol)


def test_raw_f64_matches_reference(case):
    jc, st, params, ref, method = case
    want = np.asarray(jbatch.BatchedSolver(jc, dtype=jnp.float64,
                                           refine=False)(params))
    got = BatchedSolver(st, dtype=torch.float64, refine=False,
                        device="cpu")(params)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-10
    assert _rel(got.numpy(), ref) <= 1e-10


@pytest.fixture(scope="module")
def transposed(case):
    """A right-hand side, the JAX package's raw f64 transposed solve of it
    (its f32 contract forms cost XLA compiles of 5–12 s each on the CPU;
    the f64 solve is ~κ·1e-16 from the truth, far inside 1e-9) and numpy's
    f64 one."""
    jc, st, params, _, _ = case
    rhs = np.random.default_rng(6).standard_normal((len(params), st.n))
    want = np.asarray(jbatch.BatchedSolver(
        jc, dtype=jnp.float64, refine=False)._solve_rhs_t(
            jnp.asarray(params), jnp.asarray(rhs)))
    return rhs, want, _dense_f64(jc, params, rhs, transpose=True)


@pytest.mark.parametrize("refine", ["auto", True])
def test_transposed_solve_matches_reference(case, transposed, refine):
    _, st, params, _, _ = case
    rhs, want, truth = transposed
    got = BatchedSolver(st, refine=refine, device="cpu")._solve_rhs_t(
        torch.as_tensor(params, dtype=torch.float32), torch.as_tensor(rhs))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-9
    assert _rel(got.numpy(), truth) <= 1e-6


@pytest.mark.parametrize("method", ["block", "dense"])
def test_forced_unbanded_tiers_on_a_mesh_match_reference(method):
    """A mesh the band tiers would take, forced onto the dense tiers."""
    jc, st = _stamps(list(grid_rows(9, 11, (0, 0), (8, 10)))
                     + [["src", "A", "1", "1", "g"]])
    params = _params(jc, B, seed=8)
    want = np.asarray(jbatch.BatchedSolver(jc, dtype=jnp.float32,
                                           method=method)(params))
    ts = BatchedSolver(st, method=method, device="cpu")
    assert ts.method == method
    got = ts(params)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-9
    assert _rel(got.numpy(), _dense_f64(jc, params)) <= 1e-6
