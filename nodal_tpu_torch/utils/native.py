"""ctypes binding for the native netlist parser and stamp compiler.

Counterpart of ``nodal_tpu/utils/native.py``.  Builds
``nodal_tpu_torch/cpp/fastnetlist.cpp`` (a copy of the JAX package's) on
first use with ``g++ -O3 -std=c++20`` through
:func:`nodal_tpu_torch.utils.kernels.build_host_library`, into the
package's private ``_build/`` directory, and exposes
:func:`parse_stamps`: CSV text -> the port's ``StampTensors`` + a lazy
symbol table, entirely in C++.  The Python front-end
(``nodal_tpu_torch.netlist`` + ``models.stamps``) is the semantic
reference; ``tests/test_torch_native.py`` holds the two lowerings to the
same arrays.  A failed build raises :class:`NativeUnavailable` with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from nodal_tpu_torch.models.stamps import StampTensors
from nodal_tpu_torch.utils import kernels

#: C++20 for heterogeneous (string_view) hash-map lookups.
FLAGS = ("-O3", "-std=c++20", "-shared", "-fPIC")


class NativeUnavailable(RuntimeError):
    pass


@functools.cache
def _load() -> ctypes.CDLL:
    src = kernels.CPP_DIR / "fastnetlist.cpp"
    if not src.exists():
        raise NativeUnavailable(f"source not found: {src}")
    try:
        path = kernels.build_host_library(src, FLAGS)
    except RuntimeError as e:
        raise NativeUnavailable(f"native build failed: {e}") from None
    lib = ctypes.CDLL(str(path))
    lib.fn_parse.restype = ctypes.c_void_p
    lib.fn_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
    lib.fn_error.restype = ctypes.c_char_p
    lib.fn_error.argtypes = [ctypes.c_void_p]
    lib.fn_sizes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.fn_fill_stamps.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 14
    lib.fn_fill_tables.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.fn_name.restype = ctypes.c_int64
    lib.fn_name.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.fn_node_id.restype = ctypes.c_int64
    lib.fn_node_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fn_comp_id.restype = ctypes.c_int64
    lib.fn_comp_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fn_free.argtypes = [ctypes.c_void_p]
    return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


class NativeSymbols:
    """Lazy symbol tables over the parser handle — node/component names are
    fetched on demand instead of building million-entry Python dicts."""

    def __init__(self, lib, handle, sizes, nodenum, anom_of_comp, comp_type):
        self._lib = lib
        self._handle = handle
        (self.n_components, self.n_nodes, self.n_kcl,
         self.n_be, _, _, self._ground_id) = [int(x) for x in sizes]
        self._nodenum = nodenum  # node id -> row index (-1 for ground)
        self._anom_of_comp = anom_of_comp
        self.comp_type = comp_type  # enum: 0=R 1=A 2=E 3=VCVS 4=VCCS 5=CCVS 6=CCCS

    @property
    def all_resistive(self) -> bool:
        return bool((self.comp_type == 0).all())

    def _name(self, kind: int, idx: int) -> str:
        buf = ctypes.create_string_buffer(256)
        n = self._lib.fn_name(self._handle, kind, idx, buf, 256)
        if n < 0:
            buf = ctypes.create_string_buffer(-n)
            n = self._lib.fn_name(self._handle, kind, idx, buf, -n)
        return buf.raw[:n].decode()

    @property
    def ground(self) -> str:
        return self._name(0, self._ground_id)

    def node_index(self, name: str) -> int:
        """MNA row index of a node; KeyError for unknown, -1 for ground."""
        nid = self._lib.fn_node_id(self._handle, name.encode())
        if nid < 0:
            raise KeyError(f"Node `{name}` not found in netlist")
        return int(self._nodenum[nid])

    def component_name(self, idx: int) -> str:
        return self._name(1, idx)

    def node_rows(self):
        """(name, mna_row) for every non-ground node."""
        for nid in range(self.n_nodes):
            row = int(self._nodenum[nid])
            if row >= 0:
                yield self._name(0, nid), row

    def anomalous_rows(self):
        """(component_name, mna_row) for every branch-current unknown."""
        for cid in range(self.n_components):
            a = int(self._anom_of_comp[cid])
            if a >= 0:
                yield self._name(1, cid), self.n_kcl + a

    def __del__(self):
        try:
            self._lib.fn_free(self._handle)
        except Exception:  # pragma: no cover - interpreter teardown
            pass


class NativeSlotMap:
    """Lazy component-name -> parameter-slot mapping over the parser handle.

    Duck-types the ``dict[str, int]`` surface BatchedSolver.params_with and
    monte_carlo use (``[]`` / ``in`` / iteration), without materializing a
    million-entry Python dict for generated netlists.  Iteration fetches
    names on demand (ordered by slot = netlist order).
    """

    def __init__(self, symbols: "NativeSymbols"):
        self._symbols = symbols

    def __getitem__(self, name: str) -> int:
        idx = self._symbols._lib.fn_comp_id(self._symbols._handle,
                                            name.encode())
        if idx < 0:
            raise KeyError(name)
        return int(idx)

    def __contains__(self, name: str) -> bool:
        return self._symbols._lib.fn_comp_id(
            self._symbols._handle, name.encode()) >= 0

    def __len__(self) -> int:
        return self._symbols.n_components

    def __iter__(self):
        for i in range(self._symbols.n_components):
            yield self._symbols.component_name(i)

    def __bool__(self) -> bool:
        return self._symbols.n_components > 0


def parse_stamps(text: str | bytes, *, quirks=None
                 ) -> tuple[StampTensors, NativeSymbols]:
    """CSV netlist text -> (StampTensors, NativeSymbols), all native.

    ``quirks`` is a :class:`nodal_tpu_torch.models.stamps.Quirks` — pass
    ``Quirks(vccs_as_vcvs=True)`` for reference bit-compatibility (Q1).
    """
    lib = _load()
    data = text.encode() if isinstance(text, str) else text
    flags = 0
    if quirks is not None and getattr(quirks, "vccs_as_vcvs", False):
        flags |= 1  # QUIRK_VCCS_AS_VCVS
    handle = lib.fn_parse(data, len(data), flags)
    err = lib.fn_error(handle)
    if err:
        msg = err.decode()
        lib.fn_free(handle)
        if "OPAMP" in msg:
            raise NotImplementedError(msg)
        if "not found" in msg and ("Driving" in msg or "control node" in msg):
            raise KeyError(msg)
        raise ValueError(msg)

    sizes = (ctypes.c_int64 * 7)()
    lib.fn_sizes(handle, sizes)
    n_comp, n_nodes, n_kcl, n_be, nnz_g, nnz_r, _ = [int(x) for x in sizes]

    g_rows = np.empty(nnz_g, np.int32)
    g_cols = np.empty(nnz_g, np.int32)
    g_coeff = np.empty(nnz_g, np.float64)
    g_p1 = np.empty(nnz_g, np.int32)
    g_e1 = np.empty(nnz_g, np.int8)
    g_p2 = np.empty(nnz_g, np.int32)
    g_e2 = np.empty(nnz_g, np.int8)
    r_rows = np.empty(nnz_r, np.int32)
    r_coeff = np.empty(nnz_r, np.float64)
    r_p1 = np.empty(nnz_r, np.int32)
    r_e1 = np.empty(nnz_r, np.int8)
    r_p2 = np.empty(nnz_r, np.int32)
    r_e2 = np.empty(nnz_r, np.int8)
    params = np.empty(n_comp, np.float64)
    lib.fn_fill_stamps(
        handle, _ptr(g_rows), _ptr(g_cols), _ptr(g_coeff), _ptr(g_p1),
        _ptr(g_e1), _ptr(g_p2), _ptr(g_e2), _ptr(r_rows), _ptr(r_coeff),
        _ptr(r_p1), _ptr(r_e1), _ptr(r_p2), _ptr(r_e2), _ptr(params),
    )
    nodenum = np.empty(n_nodes, np.int32)
    anom_of_comp = np.empty(n_comp, np.int32)
    comp_type = np.empty(n_comp, np.int32)
    lib.fn_fill_tables(handle, _ptr(nodenum), _ptr(anom_of_comp), _ptr(comp_type))

    stamps = StampTensors(
        n=n_kcl + n_be,
        n_kcl=n_kcl,
        g_rows=g_rows, g_cols=g_cols, g_coeff=g_coeff,
        g_p1=g_p1, g_e1=g_e1, g_p2=g_p2, g_e2=g_e2,
        rhs_rows=r_rows, rhs_coeff=r_coeff,
        rhs_p1=r_p1, rhs_e1=r_e1, rhs_p2=r_p2, rhs_e2=r_e2,
        params=params,
        param_slot={},  # replaced with the lazy native map below
    )
    symbols = NativeSymbols(
        lib, handle, list(sizes), nodenum, anom_of_comp, comp_type
    )
    # Lazy name->slot resolution straight off the C++ symbol table, so
    # native-parsed stamps compose with params_with/monte_carlo.
    stamps.param_slot = NativeSlotMap(symbols)
    return stamps, symbols
