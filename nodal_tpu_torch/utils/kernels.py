"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``nodal_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, which is
loaded with ``ctypes`` (no PyTorch headers, so the build takes seconds).
The build runs at the first CUDA call, never at import.

* The library lands in ``nodal_tpu_torch/_build/`` (git-ignored), a
  directory created with mode 0700 and refused if another user owns it or
  it is group- or world-writable, so no planted library is ever loaded.
* Its file name carries a hash of the sources and the compiler flags, so a
  library built from other sources is never loaded.
* A missing ``nvcc`` or a failed build raises ``RuntimeError`` with the
  compiler's output.  There is no fallback to another implementation.
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
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int

#: C signature of each exported launcher: (argtypes, restype).
_SIGNATURES = {
    **{name: ([_P] * 6 + [_I] * 6 + [_P], _I)
       for name in ("pcr_solve_f32", "pcr_solve_f64")},
    **{name: ([_P] * 4 + [_I] * 7 + [_P], _I)
       for name in ("sband_solve_f32", "sband_solve_f64")},
    **{name: ([_P] * 4 + [_I] * 6 + [_P], _I)
       for name in ("block_thomas_f32", "block_thomas_f64")},
}


def _sources() -> list[Path]:
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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_private_build_dir())
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed building the CUDA kernels:\n"
                f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
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
