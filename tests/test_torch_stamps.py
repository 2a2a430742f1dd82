"""Parity of the port's stamp compiler and stamp values with the JAX
package, and the port's import hygiene."""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu.models import stamps as jstamps  # noqa: E402
from nodal_tpu_torch import Netlist  # noqa: E402
from nodal_tpu_torch.models import stamps as tstamps  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows, ladder_rows  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.csv")))

SYNTHETIC = {
    "ladder": lambda: ladder_rows(12),
    "grid": lambda: list(grid_rows(4, 5, (0, 0), (3, 4))) + [
        ["src", "A", "1", "1", "g"]],
}


def _build(netlist_cls, compile_stamps, case):
    if case in SYNTHETIC:
        return compile_stamps(netlist_cls.from_rows(SYNTHETIC[case]()))
    return compile_stamps(netlist_cls(case))


def _compile_both(case):
    """(reference stamps, port stamps), or the exception types both raised."""
    try:
        ref = _build(JNetlist, jstamps.compile_stamps, case)
    except Exception as e:  # noqa: BLE001 - parity of the failure itself
        with pytest.raises(type(e)):
            _build(Netlist, tstamps.compile_stamps, case)
        return None, None
    return ref, _build(Netlist, tstamps.compile_stamps, case)


def _assert_same_stamps(ref, got):
    for f in dataclasses.fields(jstamps.StampTensors):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


CASES = [os.path.basename(p) for p in EXAMPLES] + list(SYNTHETIC)


def _case_path(case):
    return case if case in SYNTHETIC else os.path.join(REPO, "examples", case)


@pytest.mark.parametrize("case", CASES)
def test_compile_stamps_matches_reference(case):
    ref, got = _compile_both(_case_path(case))
    if ref is None:
        return  # both raised the same exception type
    _assert_same_stamps(ref, got)
    _assert_same_stamps(ref, tstamps.stamps_from_reference(ref))


@pytest.mark.parametrize("case", ["all_components.csv", "1.6.1.csv",
                                  "ladder", "grid"])
def test_stamp_values_match_reference_f64(case):
    ref, _ = _compile_both(_case_path(case))
    assert ref is not None
    port = tstamps.stamps_from_reference(ref)
    rng = np.random.default_rng(3)
    base = ref.params
    params = base * (1.0 + 0.2 * rng.standard_normal((6, len(base))))
    params[0] = base  # the netlist's own values, zeros included
    g_ref, r_ref = jstamps.stamp_values(ref, jnp.asarray(params))
    g, r = tstamps.stamp_values(port, torch.as_tensor(params))
    assert g.dtype == torch.float64 and r.dtype == torch.float64
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-15,
                               atol=0)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-15,
                               atol=0)


def test_stamps_from_reference_copies_arrays():
    ref = jstamps.compile_stamps(JNetlist.from_rows(ladder_rows(4)))
    port = tstamps.stamps_from_reference(ref)
    assert isinstance(port, tstamps.StampTensors)
    assert port.g_rows is not ref.g_rows
    assert port.param_slot is not ref.param_slot
    port.g_coeff[0] = 123.0
    assert ref.g_coeff[0] != 123.0


def test_port_imports_neither_jax_nor_reference():
    code = ("import nodal_tpu_torch, nodal_tpu_torch.batch, "
            "nodal_tpu_torch.ops.pcr, nodal_tpu_torch.utils.kernels, "
            "nodal_tpu_torch.ops.grid, nodal_tpu_torch.ops.cg, "
            "nodal_tpu_torch.ops.stencil, nodal_tpu_torch.ops.fused_cg, "
            "nodal_tpu_torch.circuit, nodal_tpu_torch.equiv, "
            "nodal_tpu_torch.solver_cli, nodal_tpu_torch.equiv_cli, "
            "nodal_tpu_torch.ops.sparse, nodal_tpu_torch.ops.amg, "
            "nodal_tpu_torch.ops.skyline, nodal_tpu_torch.utils.native, "
            "nodal_tpu_torch.ops.sparse_schur, nodal_tpu_torch.ops.reduce_e, "
            "nodal_tpu_torch.ops.grid_weighted, "
            "nodal_tpu_torch.ops.grid_weighted3, "
            "nodal_tpu_torch.ops.weighted_stencil, "
            "nodal_tpu_torch.parallel.mesh, "
            "nodal_tpu_torch.parallel.multihost, "
            "nodal_tpu_torch.parallel.halo, "
            "nodal_tpu_torch.parallel.sharded, "
            "nodal_tpu_torch.parallel.dryrun, "
            "sys; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'nodal_tpu' not in sys.modules, 'nodal_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
