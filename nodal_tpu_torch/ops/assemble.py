"""MNA system assembly from the stamp tensors, batched over a leading B.

Counterpart of ``nodal_tpu/ops/assemble.py``.  Only the values depend on the
parameters; the index tables are host numpy, copied to the device once per
topology (:func:`nodal_tpu_torch.models.stamps.device_table`).
"""

from __future__ import annotations

import numpy as np
import torch

from nodal_tpu_torch.models.stamps import (StampTensors, device_table,
                                           stamp_values)


def _as_params(params: torch.Tensor, dtype) -> torch.Tensor:
    return params if dtype is None else params.to(dtype)


def assemble_dense(stamps: StampTensors, params: torch.Tensor, dtype=None,
                   pad_to: int | None = None):
    """Dense MNA systems ``(G [B, m, m], b [B, m])`` for
    ``[B, n_components]`` params, m = ``pad_to`` or n.

    Serves the ``block`` and ``dense`` tiers and the contract layer's
    pivoted rescue.  ``pad_to`` assembles straight into the padded shape
    with a unit diagonal on the pad (the no-pivot blocked LU needs
    128-multiples), so no second copy of a multi-GB batch is made.  The
    entries sharing a slot are summed by :func:`gather_fold` in the JAX
    package's order, deterministically on every device (an atomic
    scatter-add would change the f32 sums from run to run).
    """
    params = _as_params(params, dtype)
    g_vals, rhs_vals = stamp_values(stamps, params)
    n = stamps.n
    m = n if pad_to is None else pad_to
    if m < n:
        raise ValueError(f"pad_to = {m} is below n = {n}")
    B = params.shape[0]
    G = gather_fold(stamps, f"dense_g{m}", g_vals,
                    stamps.g_rows.astype(np.int64) * m + stamps.g_cols,
                    np.arange(len(stamps.g_rows)), m * m)
    if m > n:
        pad = np.arange(n, m, dtype=np.int64) * (m + 1)
        G.index_fill_(1, device_table(stamps, f"dense_pad{m}", pad,
                                      params.device, torch.long), 1.0)
    b = gather_fold(stamps, f"dense_b{m}", rhs_vals,
                    stamps.rhs_rows.astype(np.int64),
                    np.arange(len(stamps.rhs_rows)), m)
    return G.view(B, m, m), b


def bandwidth(stamps: StampTensors) -> int:
    """Matrix bandwidth of the stamp template in natural node order.

    1 means tridiagonal (chain/ladder topologies), enabling the PCR tier."""
    if len(stamps.g_rows) == 0:
        return 0
    return int(np.max(np.abs(stamps.g_rows.astype(np.int64) - stamps.g_cols)))


def _gather_plan(rows: np.ndarray, entry_idx: np.ndarray, n: int):
    """Turn a scatter (``out[rows[e]] += vals[entry_idx[e]]``) into a dense
    gather: per-row padded entry-index matrix [n, K] + 0/1 mask, K the most
    entries landing on one row (2 for ladder diagonals)."""
    order = np.argsort(rows, kind="stable")
    rows_sorted = rows[order]
    entries_sorted = entry_idx[order]
    counts = np.bincount(rows_sorted, minlength=n)
    K = int(counts.max()) if len(counts) else 1
    idx = np.zeros((n, K), dtype=np.int32)
    mask = np.zeros((n, K), dtype=np.float64)
    slot = np.zeros(n, dtype=np.int64)
    for r, e in zip(rows_sorted, entries_sorted):
        idx[r, slot[r]] = e
        mask[r, slot[r]] = 1.0
        slot[r] += 1
    return idx, mask


def _band_gather_plans(stamps: StampTensors):
    """Host-side: per-band and RHS gather plans, cached on the stamps."""
    cached = stamps.__dict__.get("_band_gather")
    if cached is None:
        off = stamps.g_rows.astype(np.int64) - stamps.g_cols
        n = stamps.n
        plans = {}
        for o in (-1, 0, 1):
            e = np.nonzero(off == o)[0].astype(np.int32)
            plans[o] = _gather_plan(stamps.g_rows[e], e, n)
        plans["rhs"] = _gather_plan(
            stamps.rhs_rows, np.arange(len(stamps.rhs_rows), dtype=np.int32), n
        )
        stamps.__dict__["_band_gather"] = cached = plans
    return cached


def assemble_tridiag(stamps: StampTensors, params: torch.Tensor, dtype=None):
    """The three bands and the RHS ``(dl, d, du, b)``, each ``[..., n]``, for
    ``[..., n_components]`` params; no dense G at all.

    Valid when ``bandwidth(stamps) <= 1``.  Each band is a gather-fold of
    the stamp values (``(vals[..., idx] * mask).sum(-1)``), not a scatter.
    """
    params = _as_params(params, dtype)
    g_vals, rhs_vals = stamp_values(stamps, params)
    plans = _band_gather_plans(stamps)
    dev, dt = params.device, params.dtype

    def fold(vals, key):
        idx, mask = plans[key]
        i = device_table(stamps, f"band{key}_idx", idx, dev, torch.long)
        w = device_table(stamps, f"band{key}_mask", mask, dev, dt)
        return (vals[..., i] * w).sum(-1)

    dl = fold(g_vals, 1)  # G[i, i-1]
    d = fold(g_vals, 0)
    du = fold(g_vals, -1)  # G[i, i+1]
    b = fold(rhs_vals, "rhs")
    return dl, d, du, b


def _fold_table(targets: np.ndarray, entries: np.ndarray):
    """Turn the scatter ``out[targets[e]] += vals[entries[e]]`` into a
    gather-fold over the distinct targets.

    Returns ``(dest [T], ids [T, K], valid [T, K])``: ``dest`` the sorted
    distinct targets, ``ids`` the entries landing on each (in their order
    in ``entries``, zero-padded to the most any target takes) and ``valid``
    the 1/0 slot mask.  Folding ``(vals[..., ids] * valid).sum(-1)`` into
    ``dest`` is deterministic on every device, unlike an atomic scatter.
    """
    dest, inv = np.unique(targets, return_inverse=True)
    counts = np.bincount(inv, minlength=len(dest))
    K = int(counts.max()) if len(counts) else 1
    order = np.argsort(inv, kind="stable")
    offsets = np.zeros(len(dest), dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    pos = np.arange(len(inv), dtype=np.int64) - offsets[inv[order]]
    ids = np.zeros((len(dest), K), dtype=np.int64)
    valid = np.zeros((len(dest), K), dtype=np.float64)
    ids[inv[order], pos] = entries[order]
    valid[inv[order], pos] = 1.0
    return dest, ids, valid


def gather_fold(owner, name: str, vals: torch.Tensor, targets: np.ndarray,
                entries: np.ndarray, size: int) -> torch.Tensor:
    """``out[:, targets[e]] += vals[:, entries[e]]`` into a zero
    ``[B, size]``, as a deterministic gather-fold (:func:`_fold_table`).

    The fold tables are built once and cached on ``owner`` (a plan or the
    stamps) under ``name``, the device copies with :func:`device_table`.
    """
    tables = owner.__dict__.setdefault("_fold_tables", {})
    if name not in tables:
        tables[name] = _fold_table(targets, entries)
    dest, ids, valid = tables[name]
    dev = vals.device
    out = torch.zeros(vals.shape[0], size, dtype=vals.dtype, device=dev)
    if len(dest):
        i = device_table(owner, name + "_ids", ids, dev, torch.long)
        v = device_table(owner, name + "_valid", valid, dev, vals.dtype)
        d = device_table(owner, name + "_dest", dest, dev, torch.long)
        terms = vals[:, i] * v
        # Summed left to right, in the order the JAX package's fold adds
        # them, so f64 assembly agrees exactly with it (``sum(-1)`` may
        # pair the terms otherwise once a slot takes three or more).
        acc = terms[..., 0]
        for k in range(1, terms.shape[-1]):
            acc = acc + terms[..., k]
        out.index_copy_(1, d, acc)
    return out
