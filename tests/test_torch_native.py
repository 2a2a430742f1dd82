"""The port's native netlist parser (``nodal_tpu_torch/utils/native.py``
over its copy ``nodal_tpu_torch/cpp/fastnetlist.cpp``): ``parse_stamps`` of
every fixture and of random grids gives the same arrays as the port's
Python lowering (``compile_stamps``; the branch-row metadata, which the
native parser does not fill, aside), the same symbols, and the same error
messages as ``nodal_tpu.utils.native`` (``tests/test_native.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nodal_tpu.utils import native as jnative  # noqa: E402
from nodal_tpu_torch import Netlist  # noqa: E402
from nodal_tpu_torch.models.stamps import (Quirks,  # noqa: E402
                                           StampTensors, compile_stamps)
from nodal_tpu_torch.utils import kernels, native  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_csv  # noqa: E402

import fixtures as fx  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _built():
    """The parser's library, built once (not while the module imports)."""
    try:
        native._load()
    except native.NativeUnavailable as e:
        pytest.skip(f"the native parser does not build here: {e}")

ARRAYS = ("g_rows", "g_cols", "g_coeff", "g_p1", "g_e1", "g_p2", "g_e2",
          "rhs_rows", "rhs_coeff", "rhs_p1", "rhs_e1", "rhs_p2", "rhs_e2",
          "params")


def _rows(text):
    return [[f.strip() for f in r.split(",")]
            for r in text.strip().splitlines()
            if r.strip() and not r.startswith("#")]


def assert_same_stamps(text, quirks=None):
    nl = Netlist.from_rows(_rows(text))
    py = compile_stamps(nl, quirks)
    nat, symbols = native.parse_stamps(text, quirks=quirks)
    assert isinstance(nat, StampTensors)
    assert (nat.n, nat.n_kcl) == (py.n, py.n_kcl)
    for f in ARRAYS:
        got, want = getattr(nat, f), getattr(py, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert symbols.ground == nl.ground
    for node, idx in nl.nodenum.items():
        assert symbols.node_index(node) == idx
    assert dict(symbols.node_rows()) == dict(nl.nodenum)
    assert {name: row for name, row in symbols.anomalous_rows()} == \
        {name: nl.nums["kcl"] + a for name, a in nl.anomnum.items()}
    assert list(nat.param_slot) == list(py.param_slot)
    assert symbols.all_resistive == all(
        c.type == "R" for c in nl.components.values())
    return nat, symbols


@pytest.mark.parametrize(
    "name",
    ["DIVIDER", "CIRCUIT_161", "BUFFER", "OPMODEL_AMPLIFIER",
     "OPMODEL_BUFFER", "ALL_TYPES", "RESISTIVE_1", "RESISTIVE_2",
     "RESISTIVE_3", "UNCONNECTED_0"],
)
def test_parse_matches_python_fixture(name):
    assert_same_stamps(getattr(fx, name))


@pytest.mark.parametrize("h,w", [(3, 4), (5, 5), (17, 9)])
def test_parse_matches_python_random_grids(h, w):
    rng = np.random.default_rng(h * w)
    a = (int(rng.integers(h)), int(rng.integers(w)))
    b = (int(rng.integers(h)), int(rng.integers(w)))
    if a == b:
        b = ((a[0] + 1) % h, a[1])
    assert_same_stamps(grid_csv(h, w, a, b, resistance=float(
        rng.uniform(0.5, 2.0))))


def test_vccs_quirk():
    text = "e1,E,1,1,g\nr1,R,2,2,g\nd,VCCS,3,2,g,1,g\n"
    for quirks in (None, Quirks(vccs_as_vcvs=True)):
        assert_same_stamps(text, quirks)


@pytest.mark.parametrize("text,exc,match", [
    ("garbage\n", ValueError, "Missing arguments"),
    ("v1,VoltageSource,5,1,2\n", ValueError, "Unknown type"),
    ("r1,R,1,1,g\nf1,CCCS,3,2,g,1,g,nope\n", KeyError, "nope"),
    ("r1,R,0,1,g\ne1,E,1,1,g\n", ValueError, "null resistance"),
    ('"r1,R,1,1,g\n', ValueError, "quoted"),
    ("r1,R,1,1,g\nr2,R,1,2,g\nd1,VCVS,2,2,g,zz,g\n", KeyError, "zz"),
    ("u1,OPAMP,0,1,g,2,g\nr1,R,1,1,2\n", NotImplementedError, "OPAMP"),
], ids=["missing", "unknown_type", "driver", "null_r", "quote", "control",
        "opamp"])
def test_error_messages_match_jax(text, exc, match):
    with pytest.raises(exc, match=match) as got:
        native.parse_stamps(text)
    with pytest.raises(exc) as want:
        jnative.parse_stamps(text)
    assert str(got.value) == str(want.value)


def test_quoted_fields_match_csv_reader(tmp_path):
    text = ('"r1",R,1,"1",g\n'
            '"r,2",R,2,1,"n odd"\n'
            '"r""q",R,3,"n odd",g\n')
    p = tmp_path / "quoted.csv"
    p.write_text(text)
    nl = Netlist(str(p))  # csv.reader path
    py = compile_stamps(nl)
    nat, symbols = native.parse_stamps(text)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(nat, f), getattr(py, f))
    assert 'r"q' in nat.param_slot and "r,2" in nat.param_slot
    assert symbols.node_index("n odd") == nl.nodenum["n odd"]


def test_symbols_and_slot_map():
    nat, symbols = native.parse_stamps(fx.CIRCUIT_161)
    assert symbols.node_index(symbols.ground) == -1
    with pytest.raises(KeyError, match="not found"):
        symbols.node_index("nope")
    slots = nat.param_slot
    assert len(slots) == symbols.n_components and bool(slots)
    first = next(iter(slots))
    assert slots[first] == 0 and first in slots and "nope" not in slots
    with pytest.raises(KeyError):
        slots["nope"]


def test_library_lands_in_the_private_build_dir():
    lib = native._load()
    path = kernels.host_library_path(kernels.CPP_DIR / "fastnetlist.cpp",
                                     native.FLAGS)
    assert path.parent == kernels.BUILD_DIR and path.exists()
    assert lib._name == str(path)
