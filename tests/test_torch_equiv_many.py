"""The port's multi-probe equivalent resistance
(``nodal_tpu_torch/equiv.py``: ``equivalent_resistance_many``,
``equivalent_resistance_stamps``) against the JAX package's
(``nodal_tpu/equiv.py``) on the CPU, on every route: the skyline (the
default on the CPU), the block-Thomas band and the dense LU (the skyline's
profile cap set to zero in both packages), and pair by pair above
``_DENSE_MANY_MAX_N`` (patched low in both).  Resistances agree within
1e-10 relative in f64 and 1e-4 in f32; the error surface (ValueError,
KeyError, UnconnectedCircuitError, LinAlgError, an empty result for no
pairs) is the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu import equiv as jequiv  # noqa: E402
from nodal_tpu.models.stamps import compile_stamps as jcompile  # noqa: E402
from nodal_tpu.ops import skyline as jskyline  # noqa: E402
from nodal_tpu_torch import Netlist, UnconnectedCircuitError  # noqa: E402
from nodal_tpu_torch import equiv  # noqa: E402
from nodal_tpu_torch.models.stamps import stamps_from_reference  # noqa: E402
from nodal_tpu_torch.ops import skyline  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows  # noqa: E402

from test_torch_sparse import _randnet_rows  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_skyline(monkeypatch):
    """The skyline's profile cap below any profile, in both packages: the
    CPU routes go on to the band, dense or per-pair solves."""
    monkeypatch.setattr(skyline, "MAX_PROFILE_NNZ", -1)
    monkeypatch.setattr(jskyline, "MAX_PROFILE_NNZ", -1)


MESH = list(grid_rows(7, 20, (0, 0), (6, 19)))          # band, nb 2
# No band plan; the source row dropped (resistors only).
RANDNET = _randnet_rows(800, 3200, seed=1)[1:]


def _pairs(netlist, k, seed=0):
    """k probe pairs of the netlist's own nodes (ground among them)."""
    nodes = sorted(netlist.nodenum) + [netlist.ground]
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < k:
        a, b = rng.choice(len(nodes), 2, replace=False)
        out.append((nodes[a], nodes[b]))
    return out


def _both(rows, pairs, dtype=torch.float64):
    got = equiv.equivalent_resistance_many(
        Netlist.from_rows(rows), pairs, dtype=dtype, device="cpu")
    want = jequiv.equivalent_resistance_many(
        JNetlist.from_rows(rows), pairs,
        dtype=jnp.float64 if dtype == torch.float64 else jnp.float32)
    return got, np.asarray(want)


@pytest.mark.parametrize("name", ["mesh", "randnet"])
def test_skyline_route_matches_jax(name):
    rows = {"mesh": MESH, "randnet": RANDNET}[name]
    pairs = _pairs(Netlist.from_rows(rows), 12)
    got, want = _both(rows, pairs)
    assert got.dtype == np.float64 and got.shape == (12,)
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["band", "dense"])
def test_band_and_dense_routes_match_jax(no_skyline, name, dtype, rtol):
    from nodal_tpu_torch.models.stamps import compile_stamps
    from nodal_tpu_torch.ops.band import band_plan

    rows = {"band": MESH, "dense": RANDNET}[name]
    plan = band_plan(compile_stamps(Netlist.from_rows(rows)))
    assert (plan is not None and plan.nb >= 2) == (name == "band")
    pairs = _pairs(Netlist.from_rows(rows), 9, seed=2)
    got, want = _both(rows, pairs, dtype)
    np.testing.assert_allclose(got, want, rtol=rtol)
    if dtype == torch.float64:
        single = [equiv.equivalent_resistance(Netlist.from_rows(rows), a, b,
                                              device="cpu")
                  for a, b in pairs[:3]]
        np.testing.assert_allclose(got[:3], single, rtol=1e-9)


def test_per_pair_route_matches_jax(no_skyline, monkeypatch):
    monkeypatch.setattr(equiv, "_DENSE_MANY_MAX_N", 10)
    monkeypatch.setattr(jequiv, "_DENSE_MANY_MAX_N", 10)
    pairs = _pairs(Netlist.from_rows(RANDNET), 4, seed=3)
    got, want = _both(RANDNET, pairs)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_reciprocity_and_validation():
    rows = [["r1", "R", "1", "1", "2"], ["r2", "R", "2", "2", "g"],
            ["r3", "R", "3", "1", "g"]]
    nl = Netlist.from_rows(rows)
    r = equiv.equivalent_resistance_many(nl, [("1", "2"), ("2", "1")],
                                         device="cpu")
    np.testing.assert_allclose(r[0], r[1], rtol=1e-12)
    np.testing.assert_allclose(r[0], 1.0 * 5 / 6, rtol=1e-12)
    with pytest.raises(KeyError):
        equiv.equivalent_resistance_many(nl, [("1", "nope")], device="cpu")
    rows.append(["e1", "E", "1", "1", "g"])
    with pytest.raises(ValueError):
        equiv.equivalent_resistance_many(Netlist.from_rows(rows),
                                         [("1", "2")], device="cpu")


def test_empty_pairs():
    nl = Netlist.from_rows([["r1", "R", "1", "1", "g"]])
    out = equiv.equivalent_resistance_many(nl, [], device="cpu")
    assert out.shape == (0,) and out.dtype == np.float64


FLOATING = [["r1", "R", "1", "a", "b"], ["r2", "R", "1", "c", "g"]]


@pytest.mark.parametrize("route", ["skyline", "band_or_dense"])
def test_floating_netlist_raises_like_jax(request, route):
    """Two resistive islands: the reduced system is singular, and every
    route raises ``UnconnectedCircuitError`` in both packages."""
    if route != "skyline":
        request.getfixturevalue("no_skyline")
    from nodal_tpu import UnconnectedCircuitError as JUnconnected

    with pytest.raises(JUnconnected):
        jequiv.equivalent_resistance_many(JNetlist.from_rows(FLOATING),
                                          [("a", "b")])
    with pytest.raises(UnconnectedCircuitError):
        equiv.equivalent_resistance_many(Netlist.from_rows(FLOATING),
                                         [("a", "b")], device="cpu")


def test_gate_raises_linalg_error_on_a_connected_singular_solve():
    """A connected netlist whose solve misses the residual gate is
    ``LinAlgError``, not a number."""
    nl = Netlist.from_rows([["r1", "R", "1", "1", "g"]])
    X = np.full((1, 1), np.nan)
    with pytest.raises(np.linalg.LinAlgError, match="Singular"):
        equiv._gate(nl, float("nan"), X, 1.0, torch.float64)
    equiv._gate(nl, 1e-12, np.ones((1, 1)), 1.0, torch.float64)


@pytest.mark.parametrize("rows_fn,probe", [
    (lambda: MESH, ("1", "g")), (lambda: RANDNET, ("n5", "n17"))],
    ids=["mesh", "randnet"])
def test_stamps_path_matches_jax(rows_fn, probe):
    rows = rows_fn()
    jnl = JNetlist.from_rows(rows)
    jst = jcompile(jnl)
    tst = stamps_from_reference(jst)
    ia, ib = (-1 if p == jnl.ground else jnl.nodenum[p] for p in probe)
    got = equiv.equivalent_resistance_stamps(tst, ia, ib, device="cpu")
    want = jequiv.equivalent_resistance_stamps(jst, ia, ib)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_stamps_path_krylov_and_errors(no_skyline):
    jnl = JNetlist.from_rows(RANDNET)
    jst = jcompile(jnl)
    tst = stamps_from_reference(jst)
    ia, ib = jnl.nodenum["n5"], jnl.nodenum["n17"]
    got = equiv.equivalent_resistance_stamps(tst, ia, ib, device="cpu")
    want = jequiv.equivalent_resistance_stamps(jst, ia, ib)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    # A probe into a floating island: the system is inconsistent, and CG
    # stops at its 20·n iterations unconverged.
    fnl = JNetlist.from_rows(FLOATING)
    floating = stamps_from_reference(jcompile(fnl))
    with pytest.raises(equiv.NotConvergedError, match="did not converge"):
        equiv.equivalent_resistance_stamps(floating, fnl.nodenum["a"], -1,
                                           device="cpu")
    branch = stamps_from_reference(jcompile(JNetlist.from_rows(
        [["r1", "R", "1", "1", "g"], ["e1", "E", "1", "1", "g"]])))
    with pytest.raises(ValueError, match="not resistive"):
        equiv.equivalent_resistance_stamps(branch, 0, -1, device="cpu")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        equiv.equivalent_resistance_many(Netlist.from_rows(MESH),
                                         [("1", "g")])
    tst = stamps_from_reference(jcompile(JNetlist.from_rows(MESH)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        equiv.equivalent_resistance_stamps(tst, 0, -1)
