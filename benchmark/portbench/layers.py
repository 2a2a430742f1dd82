"""What the per-layer readers read from a traced run, shared by the
metric files that report one quantity in cells that report different
end-to-end metrics (``metrics/<name>.py`` names which).

``ctx.calls`` holds each traced call's kernels as ``(name, start_us,
dur_us, cat, lib)`` (``lib``: launched by the port's kernel library),
the wrappers' counters after it, and what the driver said of it.  Each
function returns None when the run gave it nothing to read.
"""

from __future__ import annotations

from roofline.bounds import level_shapes, sband_bound, stencil_bound


def torch_ops_ms(ctx):
    """Device ms a traced call spends in kernels that are not the port's
    library kernels (PyTorch operators)."""
    if not ctx.calls:
        return None
    total = sum(op[2] for call in ctx.calls for op in call["kernels"]
                if not op[4])
    return total / 1e3 / len(ctx.calls)


def kernels_per_call(ctx):
    """Device kernels a traced call launches, the library's and
    PyTorch's."""
    if not ctx.calls:
        return None
    return sum(len(call["kernels"]) for call in ctx.calls) / len(ctx.calls)


def device_idle(ctx):
    """Share of the traced calls' host span with nothing on the device,
    %."""
    return ctx.trace.idle_share() if ctx.trace is not None else None


def sband_roofline(ctx):
    """The scalar-band kernel's share of its roofline, %: the least time
    its launches could take (``sband_bound`` at the shape its wrapper
    recorded, in the dtype the kernel's name carries) over its traced
    time.  Nothing when the trace holds no scalar-band launch, or not as
    many as the wrapper counted."""
    if not ctx.calls or not ctx.whole:
        return None
    bound_ms = traced_ms = 0.0
    for call in ctx.calls:
        ops = [op for op in call["kernels"] if op[4] and "sband" in op[0]]
        shape = call["counters"]["sband_shape"]
        if len(ops) != call["counters"]["sband"] or shape is None:
            return None
        for name, _, dur, _, _ in ops:
            dtype = "float64" if "double" in name else "float32"
            bound_ms += sband_bound(*shape, dtype)["bound_ms"]
            traced_ms += dur / 1e3
    return 100.0 * bound_ms / traced_ms if traced_ms else None


def cg_iterations(ctx):
    """CG iterations a traced call, mean over the calls."""
    its = [call["info"]["iterations"] for call in ctx.calls or ()]
    if not its or None in its:
        return None
    return sum(its) / len(its)


def kernels_per_iteration(ctx):
    """Device kernels the traced calls launch over their CG
    iterations."""
    its = cg_iterations(ctx)
    if not its:
        return None
    return kernels_per_call(ctx) / its


def stencil_roofline(ctx):
    """The multigrid stencil kernels' share of their roofline, %.  Each
    V(1,1) cycle runs ``presmooth_restrict`` and ``prolong_postsmooth`` on
    each of its first ``stop`` levels and one cycle kernel from level
    ``stop`` down; the levels are the documented hierarchy
    (``level_shapes``), ``stop`` the counted transfers over the counted
    cycles, each launch bounded by ``stencil_bound`` at its field's shape.
    Nothing when a call took another route (Jacobi sweeps, unequal
    transfer counts) or the trace is not whole."""
    if not ctx.calls or not ctx.whole:
        return None
    shapes = level_shapes(int(ctx.config["h"]), int(ctx.config["w"]))
    bound_ms = traced_ms = 0.0
    for call in ctx.calls:
        c = call["counters"]
        cycles, pre = c["vcycle"], c["presmooth_restrict"]
        if (c["jacobi_sweeps"] or not cycles or pre != c["prolong_postsmooth"]
                or pre % cycles or pre // cycles >= len(shapes)):
            return None
        stop = pre // cycles
        B, dtype = call["info"]["fields"], call["info"]["dtype"]
        one = sum(stencil_bound(name, B, *shapes[lv], dtype)["bound_ms"]
                  for lv in range(stop)
                  for name in ("presmooth_restrict", "prolong_postsmooth"))
        one += stencil_bound("vcycle", B, *shapes[stop], dtype)["bound_ms"]
        bound_ms += cycles * one
        traced_ms += sum(op[2] for op in call["kernels"] if op[4]) / 1e3
    return 100.0 * bound_ms / traced_ms if traced_ms else None
