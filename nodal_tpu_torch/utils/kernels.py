"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``nodal_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` (with ``csrc/`` on the include path for any ``*.cuh``
header), one ``nvcc`` process a source, all started together, and the
objects are linked into one shared library with a plain C interface,
which is loaded with ``ctypes`` (no PyTorch headers, so the build takes
seconds).  The build runs at the first CUDA call, never at import.

* The library lands in ``nodal_tpu_torch/_build/`` (git-ignored), a
  directory created with mode 0700 and refused if another user owns it or
  it is group- or world-writable, so no planted library is ever loaded.
* Its file name carries a hash of the sources, headers included, and the
  compiler flags, so a library built from other sources is never loaded.
* A missing ``nvcc`` or a failed build raises ``RuntimeError`` with the
  compiler's output.  There is no fallback to another implementation.

The host C++ sources of the port (``nodal_tpu_torch/cpp/``: the skyline
LDLᵀ and the native netlist parser) are built by :func:`build_host_library`
with ``g++`` into the same directory, under the same rules.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import stat
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
CPP_DIR = _PKG / "cpp"
BUILD_DIR = _PKG / "_build"

COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC")
#: Every flag of the build, hashed into the library's name.
NVCC_FLAGS = COMPILE_FLAGS + ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_LL = ctypes.c_longlong

#: C signature of each exported launcher: (argtypes, restype).
_SIGNATURES = {
    **{name: ([_P] * 6 + [_I] * 6 + [_P], _I)
       for name in ("pcr_solve_f32", "pcr_solve_f64")},
    **{name: ([_P] * 4 + [_I] * 7 + [_P], _I)
       for name in ("sband_solve_f32", "sband_solve_f64")},
    **{name: ([_P] * 4 + [_I] * 4 + [_P], _I)
       for name in ("block_thomas_f32", "block_thomas_f64")},
    **{name: ([_P] * 2 + [_I] * 2 + [_P], _I)
       for name in ("block_lu_factor_f32", "block_lu_factor_f64")},
    **{name: ([_P] * 3 + [_I] * 3 + [_P], _I)
       for name in ("block_lu_solve_f32", "block_lu_solve_f64")},
    **{name: ([_P] * 3 + [_I] * 5 + [_D] * 2 + [_P], _I)
       for name in ("stencil_jacobi_f32", "stencil_jacobi_f64")},
    **{name: ([_P] * 3 + [_I] * 5 + [_D] * 2 + [_P], _I)
       for name in ("stencil_presmooth_restrict_f32",
                    "stencil_presmooth_restrict_f64")},
    **{name: ([_P] * 4 + [_I] * 5 + [_D] * 2 + [_P], _I)
       for name in ("stencil_prolong_postsmooth_f32",
                    "stencil_prolong_postsmooth_f64")},
    **{name: ([_P] * 2 + [_I] * 2 + [_P] * 2 + [_I] * 2 + [_D] * 2 + [_P],
              _I)
       for name in ("stencil_vcycle_f32", "stencil_vcycle_f64")},
    **{name: ([_P] * 2 + [_I] * 2 + [_P] * 2 + [_I] * 4 + [_D] * 2 + [_P],
              _I)
       for name in ("stencil_vcycle_cluster_f32",
                    "stencil_vcycle_cluster_f64")},
    **{name: ([_P] * 3 + [_I] * 6 + [_D] * 2 + [_P], _I)
       for name in ("stencil_jacobi_cluster_f32",
                    "stencil_jacobi_cluster_f64")},
    **{name: ([_I, _P], _I)
       for name in ("stencil_max_cluster_f32", "stencil_max_cluster_f64")},
    **{name: ([_P] * 3 + [_I, _LL, _P], _I)
       for name in ("stencil_subtract_mean_f32",
                    "stencil_subtract_mean_f64")},
    **{name: ([_P] * 3 + [_I] * 5 + [_D, _P], _I)
       for name in ("cg_stencil_partials_f32", "cg_stencil_partials_f64")},
    **{name: ([_P] * 9 + [_I] * 3 + [_P], _I)
       for name in ("cg_update_partials_f32", "cg_update_partials_f64")},
    **{name: ([_P] * 7 + [_I] * 5 + [_P], _I)
       for name in ("wstencil_residual_f32", "wstencil_residual_f64")},
    **{name: ([_P] * 7 + [_I] * 4 + [_D, _P], _I)
       for name in ("wstencil_jacobi_f32", "wstencil_jacobi_f64")},
    **{name: ([_P] * 5 + [_I] * 6 + [_D, _P], _I)
       for name in ("wstencil_jacobi_block_f32",
                    "wstencil_jacobi_block_f64")},
}


def _sources() -> list[Path]:
    """Every source and header under ``csrc/``: what the library hash
    covers.  Only the ``.cu`` files are compiled."""
    return sorted(p for p in CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    return BUILD_DIR / f"libnodal_kernels_{h.hexdigest()[:16]}.so"


def _private_build_dir() -> Path:
    BUILD_DIR.mkdir(mode=0o700, exist_ok=True)
    st = BUILD_DIR.stat()
    if st.st_uid != os.getuid() or st.st_mode & (stat.S_IWGRP | stat.S_IWOTH):
        raise RuntimeError(
            f"refusing to build into {BUILD_DIR}: it must be owned by this "
            "user and writable by no one else")
    return BUILD_DIR


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "of nodal_tpu_torch cannot be built")


def build() -> Path:
    """Compile the sources into :func:`library_path` unless it exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    build_dir = _private_build_dir()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        with tempfile.TemporaryDirectory(dir=build_dir) as obj_dir:
            objs, procs = [], []
            for src in (p for p in _sources() if p.suffix == ".cu"):
                obj = os.path.join(obj_dir, src.stem + ".o")
                cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC_DIR), "-c",
                       "-o", obj, str(src)]
                objs.append(obj)
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            # Wait for every compiler before reporting any failure.
            outputs = [proc.communicate() for _, proc in procs]
            for (cmd, proc), (stdout, stderr) in zip(procs, outputs):
                _raise_on_failure(cmd, proc.returncode, stdout, stderr)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            _raise_on_failure(cmd, proc.returncode, proc.stdout, proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _raise_on_failure(cmd, returncode, stdout, stderr,
                      what: str = "the CUDA kernels") -> None:
    if returncode != 0:
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed building {what}:\n"
            f"$ {' '.join(cmd)}\n{stdout}{stderr}")


def host_library_path(src: Path, flags: tuple[str, ...]) -> Path:
    """Where the shared library of the host C++ source ``src`` built with
    ``flags`` lives: its name carries a hash of both."""
    h = hashlib.sha256(" ".join(flags).encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_host_library(src: Path, flags: tuple[str, ...]) -> Path:
    """Compile the host C++ source ``src`` with ``g++ flags`` into
    :func:`host_library_path` unless it exists, atomically, as
    :func:`build` does.  A missing ``g++`` or a failed build raises
    ``RuntimeError`` with the compiler's output."""
    out = host_library_path(src, flags)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {src.name} cannot be "
                           "built")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_private_build_dir())
    os.close(fd)
    try:
        cmd = [gxx, *flags, str(src), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _raise_on_failure(cmd, proc.returncode, proc.stdout, proc.stderr,
                          src.name)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library, with every launcher's C signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
