"""The port's tolerance analysis (``nodal_tpu_torch/batch.py``:
``monte_carlo``, ``_mc_run``, ``sensitivities``) and equivalent resistance
(``nodal_tpu_torch/equiv.py``) against the JAX package's, on the CPU.

``_mc_run`` is fed the JAX package's own draws
(``jax.random.normal(PRNGKey(seed), (n, k), dtype)``, what its
``monte_carlo`` samples), so both packages solve the same samples: means,
standard deviations and solutions agree within 1e-6 of max|mean| for f32
``refine="auto"`` (both inside the 1e-6 contract of the f64 answer) and
1e-10 for raw f64.  The audits are compared only where both are f64 (the
port audits in f64 always; the JAX package audits a raw f32 sweep in f32,
whose floor reads far above the exact residual).  Sensitivities agree to
1e-8 of the largest entry, equivalent resistances to 1e-12.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nodal_tpu as J  # noqa: E402
from nodal_tpu import batch as jbatch  # noqa: E402
from nodal_tpu import equiv as jequiv  # noqa: E402
from nodal_tpu_torch import Circuit, Netlist  # noqa: E402
from nodal_tpu_torch import batch as tbatch  # noqa: E402
from nodal_tpu_torch import equiv  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows, ladder_rows  # noqa: E402

import fixtures as fx  # noqa: E402

_DIVIDER_ROWS = [["1", "A", "1", "1", "3"], ["r2", "R", "1", "2", "3"],
                 ["r3", "R", "1", "1", "2"]]
_161_ROWS = [r.split(",") for r in (
    "r1,R,2,1,4", "r2,R,2,1,g", "r3,R,0.5,1,2",
    "e1,E,8,4,g", "a1,A,4,1,2", "d1,CCCS,2,2,g,1,g,r2")]

MC_CASES = {
    "divider": (_DIVIDER_ROWS, {"r3": 0.05}),
    "ladder16": (ladder_rows(16), {f"rs{k}": 0.05 for k in range(16)}),
}
MC_MODES = {"f32_auto": (torch.float32, jnp.float32, "auto", 1e-6),
            "f64_raw": (torch.float64, jnp.float64, False, 1e-10)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _circuits(rows):
    return (J.Circuit(J.Netlist.from_rows(rows)),
            Circuit(Netlist.from_rows(rows), device="cpu"))


def _port_run(tc, tolerances, noise, dtype, refine, want=True, check=True):
    """The port's ``_mc_run`` on given draws, set up as ``monte_carlo``
    sets it up."""
    stamps = tc.stamps
    solver = tc.batched_solver(dtype=dtype, refine=refine)
    names = list(tolerances)
    slots = torch.tensor([stamps.param_slot[m] for m in names])
    sigmas = torch.tensor([tolerances[m] for m in names], dtype=dtype)
    base = torch.as_tensor(stamps.params, dtype=dtype)
    return tbatch._mc_run(solver, stamps, base, slots, sigmas,
                          torch.as_tensor(noise, dtype=dtype), want, check)


def _jax_noise(seed, n, k, jdtype):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, k),
                                      dtype=jdtype))


@pytest.mark.parametrize("mode", list(MC_MODES))
@pytest.mark.parametrize("case", list(MC_CASES))
def test_mc_run_matches_jax_monte_carlo(case, mode):
    rows, tolerances = MC_CASES[case]
    dtype, jdtype, refine, tol = MC_MODES[mode]
    n, seed = 512, 3
    jc, tc = _circuits(rows)
    jout = jbatch.monte_carlo(jc, tolerances, n, seed=seed, dtype=jdtype,
                              refine=refine, return_solutions=True)
    noise = _jax_noise(seed, n, len(tolerances), jdtype)
    mean, std, xs, batch, audit = _port_run(tc, tolerances, noise, dtype,
                                            refine)
    jmean = np.asarray(jout["mean"])
    scale = np.abs(jmean).max()
    assert mean.dtype == torch.float64 and mean.shape == jmean.shape
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(std.numpy(), np.asarray(jout["std"]), rtol=0,
                               atol=tol * scale)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jout["solutions"]),
                               rtol=0, atol=tol * scale)
    # Both audits are f64 here (the auto sweep's solutions are f64).
    assert float(audit[0]) <= 1e-12 and jout["max_residual"] <= 1e-12
    assert int(audit[1]) == 0
    assert batch.dtype == dtype and batch.shape == (n, len(tc.stamps.params))


def test_mc_divider_statistics():
    """``tests/test_batch.py``'s divider: e(2) = −r3·1 A, 5 % on r3."""
    tc = Circuit(Netlist.from_rows(_DIVIDER_ROWS), device="cpu")
    out = tbatch.monte_carlo(tc, {"r3": 0.05}, n=2048, seed=1)
    node2 = tc.netlist.nodenum["2"]
    np.testing.assert_allclose(float(out["mean"][node2]), -1.0, atol=0.01)
    np.testing.assert_allclose(float(out["std"][node2]), 0.05, atol=0.01)
    assert out["max_residual"] <= 1e-6


def test_mc_negative_draws_refined_not_warned(caplog):
    """``tests/test_contract_tier.py``'s case: 60 % tolerances draw
    negative values; ``refine="auto"`` keeps the contract and logs no
    warning, on the port's draws and on the JAX package's."""
    rows = ladder_rows(48)
    tolerances = {f"rs{k}": 0.6 for k in range(48)}
    jc, tc = _circuits(rows)
    with caplog.at_level(logging.WARNING, logger="nodal_tpu_torch.batch"):
        out = tbatch.monte_carlo(tc, tolerances, n=512, seed=5)
    assert out["max_residual"] <= 1e-6
    assert not [r for r in caplog.records if "exceed residual" in r.message]
    noise = _jax_noise(5, 512, 48, jnp.float32)
    mean, _, _, _, audit = _port_run(tc, tolerances, noise, torch.float32,
                                     "auto", want=False)
    jout = jbatch.monte_carlo(jc, tolerances, 512, seed=5)
    assert float(audit[0]) <= 1e-6 and jout["max_residual"] <= 1e-6
    jmean = np.asarray(jout["mean"])
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=0,
                               atol=1e-6 * np.abs(jmean).max())


def test_mc_raw_f32_warning_in_both(caplog):
    """A raw f32 sweep far outside the no-pivot domain (300 % tolerances):
    both packages log the same warning.  Their counts differ: the JAX
    package reads its f32 audit, the port the exact f64 residual."""
    rows = ladder_rows(16)
    tolerances = {f"rs{k}": 3.0 for k in range(16)}
    jc, tc = _circuits(rows)
    with caplog.at_level(logging.WARNING):
        jout = jbatch.monte_carlo(jc, tolerances, 512, seed=5, refine=False)
        out = tbatch.monte_carlo(tc, tolerances, 512, seed=5, refine=False)
    msgs = {r.name: r.getMessage() for r in caplog.records
            if "exceed residual" in r.getMessage()}
    assert set(msgs) == {"nodal_tpu.batch", "nodal_tpu_torch.batch"}
    tail = lambda m: m.split(")", 1)[1]  # noqa: E731 - counts differ
    assert tail(msgs["nodal_tpu.batch"]) == tail(msgs["nodal_tpu_torch.batch"])
    assert jout["max_residual"] > 1e-3 and out["max_residual"] > 1e-3
    # The port's audit is the exact f64 residual of its f32 answers.
    xs = tbatch.monte_carlo(tc, tolerances, 512, seed=5, refine=False,
                            return_solutions=True, audit="exact")
    assert xs["max_residual"] == out["max_residual"]


def test_mc_reproducible_by_seed():
    tc = Circuit(Netlist.from_rows(ladder_rows(16)), device="cpu")
    tolerances = {f"rp{k}": 0.05 for k in range(16)}
    a = tbatch.monte_carlo(tc, tolerances, 256, seed=11)
    b = tbatch.monte_carlo(tc, tolerances, 256, seed=11)
    c = tbatch.monte_carlo(tc, tolerances, 256, seed=12)
    assert torch.equal(a["mean"], b["mean"]) and torch.equal(a["std"],
                                                             b["std"])
    assert not torch.equal(a["mean"], c["mean"])
    assert tc.batched_solver() is tc.batched_solver(device="cpu")


def test_mc_exact_audit_solutions_and_bare_stamps():
    tc = Circuit(Netlist.from_rows(ladder_rows(16)), device="cpu")
    tolerances = {f"rs{k}": 0.05 for k in range(16)}
    fused = tbatch.monte_carlo(tc, tolerances, 128, seed=2)
    exact = tbatch.monte_carlo(tc, tolerances, 128, seed=2, audit="exact",
                               return_solutions=True)
    assert exact["max_residual"] == fused["max_residual"]
    assert exact["solutions"].shape == (128, tc.stamps.n)
    assert torch.equal(exact["mean"], fused["mean"])
    assert "solutions" not in fused
    off = tbatch.monte_carlo(tc, tolerances, 128, seed=2, audit=False)
    assert "max_residual" not in off
    bare = tbatch.monte_carlo(tc.stamps, tolerances, 128, seed=2,
                              device="cpu")
    assert torch.equal(bare["mean"], fused["mean"])


def test_mc_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    tc = Circuit(Netlist.from_rows(ladder_rows(4)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.monte_carlo(tc, {"rs0": 0.05}, 8)


SENS_CASES = {
    "161_current": (_161_ROWS, {"current": "e1"}),
    "161_potential": (_161_ROWS, {"potential": "2"}),
    "ladder": (ladder_rows(32), {"potential": "n3"}),
    "mesh": (list(grid_rows(9, 12, (0, 0), (8, 11)))
             + [["src", "A", "1", "1", "g"]], {"potential": "n4_5"}),
    "branch": (list(grid_rows(17, 16, (0, 0), (16, 15)))
               + [["e1", "E", "2", "1", "g"],
                  ["d1", "VCCS", "0.5", "n3_3", "g", "1", "g"]],
               {"current": "e1"}),
}


@pytest.mark.parametrize("case", list(SENS_CASES))
def test_sensitivities_match_jax(case):
    rows, target = SENS_CASES[case]
    jc, tc = _circuits(rows)
    want = jbatch.sensitivities(jc, **target)
    got = tbatch.sensitivities(tc, **target)
    assert list(got) == list(want)
    w = np.array([want[k] for k in want])
    g = np.array([got[k] for k in want])
    assert np.abs(g - w).max() <= 1e-8 * np.abs(w).max(), case
    assert tc.batched_solver(dtype=torch.float64).method == \
        jbatch.BatchedSolver(jc, dtype=jnp.float64).method


def test_sensitivities_ground_and_errors_match_jax():
    jc, tc = _circuits(ladder_rows(8))
    gnd = tc.netlist.ground
    for sens, c in ((jbatch.sensitivities, jc), (tbatch.sensitivities, tc)):
        assert all(v == 0.0 for v in sens(c, potential=gnd).values())
        with pytest.raises(ValueError):
            sens(c)
        with pytest.raises(ValueError):
            sens(c, potential="n0", current="rs0")
        with pytest.raises(KeyError):
            sens(c, potential="nope")
        with pytest.raises(KeyError):
            sens(c, current="rs0")


@pytest.mark.parametrize("rows,kw", [
    (ladder_rows(8), {"potential": "n0"}),
    (_161_ROWS, {"potential": "2"}), (_161_ROWS, {"current": "e1"})],
    ids=["ladder", "161_e2", "161_ie1"])
def test_sensitivities_sparse_matches_jax(rows, kw):
    """A ``sparse=True`` circuit takes the bordered elimination's adjoint
    in both packages: the same gradients within 1e-8 of the largest."""
    jc = J.Circuit(J.Netlist.from_rows(rows), sparse=True)
    tc = Circuit(Netlist.from_rows(rows), sparse=True, device="cpu")
    got = tbatch.sensitivities(tc, **kw)
    want = jbatch.sensitivities(jc, **kw)
    assert list(got) == list(want)
    scale = max(max(abs(v) for v in want.values()), 1.0)
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-8 * scale, name


@pytest.mark.parametrize("text,expected", [
    (fx.RESISTIVE_1, 2.0), (fx.RESISTIVE_2, 1.0), (fx.RESISTIVE_3, 1.0)],
    ids=["resistive_1", "resistive_2", "resistive_3"])
def test_equivalent_resistance_matches_jax(tmp_netlist, text, expected):
    path = tmp_netlist(text)
    r = equiv.equivalent_resistance(Netlist(path), "1", "g", device="cpu")
    jr = jequiv.equivalent_resistance(J.Netlist(path), "1", "g")
    assert abs(r - jr) <= 1e-12 * abs(jr)
    np.testing.assert_allclose(r, expected, rtol=1e-8)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_equivalent_resistance_examples(k):
    path = f"examples/resistive_{k}.csv"
    r = equiv.equivalent_resistance(Netlist(path), "1", "g", device="cpu")
    jr = jequiv.equivalent_resistance(J.Netlist(path), "1", "g")
    assert abs(r - jr) <= 1e-12 * abs(jr)
    rs = equiv.resistance_sensitivities(Netlist(path), "1", "g",
                                        device="cpu")
    jrs = jequiv.resistance_sensitivities(J.Netlist(path), "1", "g")
    assert list(rs) == list(jrs)
    for name in jrs:
        assert abs(rs[name] - jrs[name]) <= 1e-12, name


def test_equivalent_resistance_validation(tmp_netlist):
    net = Netlist(tmp_netlist(fx.CIRCUIT_161))
    assert not equiv.check_resistive(net)
    assert equiv.check_resistive(Netlist(tmp_netlist(fx.RESISTIVE_1)))
    for fn in (equiv.equivalent_resistance, equiv.resistance_sensitivities):
        with pytest.raises(ValueError):
            fn(net, "1", "g", device="cpu")
        with pytest.raises(KeyError):
            fn(Netlist(tmp_netlist(fx.RESISTIVE_1)), "42", "g",
               device="cpu")


def test_probe_name_collision_and_no_mutation(tmp_netlist):
    """Quirk Q4: a component already named ``a1`` keeps its name; the
    netlist given is not changed."""
    net = Netlist(tmp_netlist("a1, R, 1, 1, 2\nr2, R, 1, 2, g\n"))
    keys = list(net.component_keys)
    r = equiv.equivalent_resistance(net, "1", "g", device="cpu")
    np.testing.assert_allclose(r, 2.0, rtol=1e-8)
    assert net.component_keys == keys


def test_resistance_sensitivities_match_jax():
    """``tests/test_equiv.py``'s closed forms and bridge network."""
    cases = [
        [["r1", "R", "2", "1", "2"], ["r2", "R", "3", "2", "g"]],
        [["r1", "R", "2", "1", "g"], ["r2", "R", "3", "1", "g"]],
        [["r1", "R", "1", "1", "2"], ["r2", "R", "2", "1", "3"],
         ["r3", "R", "3", "2", "3"], ["r4", "R", "4", "2", "g"],
         ["r5", "R", "5", "3", "g"]],
    ]
    for rows in cases:
        got = equiv.resistance_sensitivities(Netlist.from_rows(rows), "1",
                                             "g", device="cpu")
        want = jequiv.resistance_sensitivities(J.Netlist.from_rows(rows),
                                               "1", "g")
        assert list(got) == list(want)
        for name in want:
            assert abs(got[name] - want[name]) <= 1e-12, (rows, name)
    s = equiv.resistance_sensitivities(Netlist.from_rows(cases[1]), "1",
                                       "g", device="cpu")
    assert abs(s["r1"] - (3 / 5) ** 2) < 1e-12
    assert abs(s["r2"] - (2 / 5) ** 2) < 1e-12
