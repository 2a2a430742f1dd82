"""Batched no-pivot blocked LU: the hand-written CUDA kernel and its wrapper.

Counterpart of the Pallas kernels of ``nodal_tpu/ops/pallas_block_lu.py``
(``pallas_lu_solve`` and ``pallas_lu_solve_multi``), which one source,
``csrc/block_lu.cu``, replaces.  Its plain version is
:func:`nodal_tpu_torch.ops.block_lu.blocked_factor` with
:func:`~nodal_tpu_torch.ops.block_lu.blocked_solve_factored`.

G is ``[B, n_pad, n_pad]`` with n_pad a multiple of 128 and a unit
diagonal on any pad (``assemble_dense(pad_to=...)``), as in the JAX
package.  The factorization and the solve are separate calls, so one
factor serves several defect-correction solves.  CPU tensors take the
plain version; CUDA tensors launch the kernel or raise: there is no
fallback.  The kernel serves every n_pad, any batch and any number of
right-hand sides, in float32 and float64.
"""

from __future__ import annotations

import torch

from nodal_tpu_torch.ops.block_lu import (_BLOCK, blocked_factor,
                                          blocked_solve,
                                          blocked_solve_factored)

#: Panel width; must match ``kBlock`` in ``csrc/block_lu.cu``.
BLOCK = _BLOCK


def _check_matrix(G: torch.Tensor, fn: str) -> None:
    if G.dim() != 3 or G.shape[1] != G.shape[2]:
        raise ValueError(f"{fn} expects G [B, n_pad, n_pad], got "
                         f"{tuple(G.shape)}")
    if G.shape[1] == 0 or G.shape[1] % BLOCK:
        raise ValueError(f"{fn}: n_pad = {G.shape[1]} is not a positive "
                         f"multiple of {BLOCK} (assemble with pad_to)")
    if G.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{fn} supports float32 and float64, not {G.dtype}")
    if G.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on CPU or CUDA tensors, not {G.device}")
    if G.device.type == "cuda" and not G.is_contiguous():
        raise ValueError(f"{fn}: G must be contiguous")


def _check_rhs(G: torch.Tensor, R: torch.Tensor, fn: str) -> None:
    if R.dim() != 3 or R.shape[:2] != G.shape[:2]:
        raise ValueError(f"{fn}: R {tuple(R.shape)} does not match G "
                         f"{tuple(G.shape)}: expected [{G.shape[0]}, "
                         f"{G.shape[1]}, r]")
    if R.shape[2] < 1:
        raise ValueError(f"{fn}: R has no right-hand sides")
    if R.dtype != G.dtype:
        raise TypeError(f"{fn}: G is {G.dtype}, R is {R.dtype}")
    if R.device != G.device:
        raise ValueError(f"{fn}: G is on {G.device}, R is on {R.device}")


def _raise_on(err: int, what: str, shape, dtype) -> None:
    if err != 0:
        raise RuntimeError(f"blocked-LU {what} failed with CUDA error {err} "
                           f"({shape}, {dtype})")


def lu_factor(G: torch.Tensor):
    """Factor ``G`` [B, n_pad, n_pad] without pivoting.

    CUDA tensors: the kernel factors G in place (the caller's assembled G
    is a temporary) and returns it, packed: the inverted diagonal blocks,
    the Schur-updated column panels below them and row panels right of
    them.  Each call adds one to ``lu_factor.launches``.  CPU tensors: the
    plain :func:`blocked_factor`'s list of panels; G is left as it was.
    """
    _check_matrix(G, "lu_factor")
    if G.device.type == "cpu":
        return blocked_factor(G)
    B, n, _ = G.shape
    if B == 0:
        return G

    from nodal_tpu_torch.utils.kernels import load_library

    lib = load_library()
    P = torch.empty(B * BLOCK * (n - BLOCK), dtype=G.dtype, device=G.device)
    fn = lib.block_lu_factor_f32 if G.dtype == torch.float32 else \
        lib.block_lu_factor_f64
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        err = fn(G.data_ptr(), P.data_ptr(), B, n, stream)
    _raise_on(err, "factorization", tuple(G.shape), G.dtype)
    lu_factor.launches += 1
    return G


lu_factor.launches = 0


def lu_solve_factored(F, R: torch.Tensor) -> torch.Tensor:
    """Solve with a factor of :func:`lu_factor` for ``R`` [B, n_pad, r]
    (any r) -> X [B, n_pad, r], in the dtype of the inputs.

    CUDA: the kernel's two sweeps; each call adds one to
    ``lu_solve_factored.launches`` and records ``(B, n_pad, r)`` in
    ``lu_solve_factored.last_shape``.  CPU: the plain
    :func:`blocked_solve_factored` on the panel list.
    """
    if not isinstance(F, torch.Tensor):
        if R.device.type != "cpu":
            raise ValueError("a CPU factor (panel list) takes CPU right-hand "
                             f"sides, not {R.device}")
        return blocked_solve_factored(F, R)
    _check_matrix(F, "lu_solve_factored")
    _check_rhs(F, R, "lu_solve_factored")
    if F.device.type == "cpu":
        raise ValueError("lu_solve_factored: a packed factor lives on CUDA; "
                         "on the CPU pass lu_factor's panel list")
    B, n, _ = F.shape
    r = R.shape[2]
    X = R.contiguous().clone()
    if B == 0:
        return X

    from nodal_tpu_torch.utils.kernels import load_library

    lib = load_library()
    Z = torch.empty(B * BLOCK * r, dtype=F.dtype, device=F.device)
    fn = lib.block_lu_solve_f32 if F.dtype == torch.float32 else \
        lib.block_lu_solve_f64
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = fn(F.data_ptr(), X.data_ptr(), Z.data_ptr(), B, n, r, stream)
    _raise_on(err, "solve", (B, n, r), F.dtype)
    lu_solve_factored.launches += 1
    lu_solve_factored.last_shape = (B, n, r)
    return X


lu_solve_factored.launches = 0
lu_solve_factored.last_shape = None


def lu_solve_multi(G: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """``G⁻¹ R`` for ``G`` [B, n_pad, n_pad] and ``R`` [B, n_pad, r]; on
    CUDA, G is factored in place."""
    _check_matrix(G, "lu_solve_multi")
    _check_rhs(G, R, "lu_solve_multi")
    return lu_solve_factored(lu_factor(G), R)


def lu_solve(G: torch.Tensor, b: torch.Tensor,
             n_valid: int | None = None) -> torch.Tensor:
    """Single right-hand side: ``G`` [B, n_pad, n_pad], ``b`` [B, n_pad] ->
    x [B, n_pad], or its first ``n_valid`` unknowns.  CPU tensors take the
    plain :func:`blocked_solve`; on CUDA, G is factored in place."""
    _check_matrix(G, "lu_solve")
    if b.dim() != 2:
        raise ValueError(f"lu_solve expects b [B, n_pad], got "
                         f"{tuple(b.shape)}")
    if G.device.type == "cpu":
        _check_rhs(G, b.unsqueeze(-1), "lu_solve")
        x = blocked_solve(G, b)
    else:
        x = lu_solve_multi(G, b.unsqueeze(-1))[..., 0]
    return x if n_valid is None else x[..., :n_valid]
