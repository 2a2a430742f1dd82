"""The trace reduction and the per-layer readers on a synthetic trace:
which kernels are the port's library's, the busy time and idle gaps of
the window, and the rooflines from the counters and the frozen bounds."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import layers
from portbench.trace import Trace, kernel_name
from roofline.bounds import level_shapes, sband_bound, stencil_bound


def _events():
    """Two calls.  In each, an autograd Function's forward (a cpu_op that
    is not PyTorch's) launches a library kernel through ctypes and an
    ``aten::mul`` launches a PyTorch kernel."""
    ev = []
    for i, t in enumerate((0.0, 1000.0)):
        label = f"c{i}"
        ev.append({"cat": "user_annotation", "name": label, "ts": t,
                   "dur": 900.0, "tid": 1})
        ev.append({"cat": "cpu_op", "name": "_AdjointSolve", "ts": t + 10,
                   "dur": 800.0, "tid": 1})
        ev.append({"cat": "cpu_op", "name": "aten::mul", "ts": t + 500,
                   "dur": 50.0, "tid": 1})
        for corr, ts, name, start, dur in (
                (2 * i, t + 20, "void sband_reg_kernel<float, 27>(float*)",
                 t + 30, 400.0),
                (2 * i + 1, t + 510,
                 "void at::native::elementwise_kernel<4>()", t + 520, 100.0)):
            ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": ts, "dur": 5.0, "tid": 1,
                       "args": {"correlation": corr}})
            ev.append({"cat": "kernel", "name": name, "ts": start,
                       "dur": dur, "args": {"correlation": corr}})
    return ev


def test_library_kernels_busy_time_and_gaps():
    tr = Trace(_events(), ["c0", "c1"])
    for label in ("c0", "c1"):
        ks = tr.kernels(label)
        assert [(kernel_name(k[0]), k[4]) for k in ks] == [
            ("sband_reg_kernel", True), ("elementwise_kernel", False)]
    assert tr.window_us == 1900.0
    assert tr.busy_us == pytest.approx(2 * 500.0)
    assert tr.idle_share() == pytest.approx(100 * (1 - 1000 / 1900))
    names = dict(tr.top_device_ops())
    assert names["sband_reg_kernel"] == pytest.approx(800e-6)
    gaps = dict(tr.idle_by_host())
    assert sum(gaps.values()) == pytest.approx(900e-6)
    assert "_AdjointSolve" in gaps


def test_sband_roofline_from_counters():
    tr = Trace(_events(), ["c0", "c1"])
    shape = (16384, 999, 27, 1)
    calls = [{"kernels": tr.kernels(label),
              "counters": {"sband": 1, "pcr": 0, "sband_shape": shape}}
             for label in ("c0", "c1")]
    ctx = SimpleNamespace(calls=calls, whole=True, trace=tr)
    want = 100 * sband_bound(*shape, "float32")["bound_ms"] / 0.4
    assert layers.sband_roofline(ctx) == pytest.approx(want)
    assert layers.torch_ops_ms(ctx) == pytest.approx(0.1)
    assert layers.kernels_per_call(ctx) == 2
    calls[1]["counters"] = {**calls[1]["counters"], "sband": 2}
    assert layers.sband_roofline(ctx) is None  # a launch the trace lost
    assert layers.sband_roofline(SimpleNamespace(calls=calls,
                                                 whole=False)) is None


def test_stencil_roofline_from_counters():
    lib = [("void presmooth_restrict_strip<float>()", 0, 10.0, "kernel",
            True)] * 36 + [("void vcycle_cluster<float>()", 0, 50.0,
                            "kernel", True)] * 9
    counters = {"jacobi_sweeps": 0, "presmooth_restrict": 18,
                "prolong_postsmooth": 18, "vcycle": 9}
    call = {"kernels": lib, "counters": counters,
            "info": {"fields": 1, "iterations": 8, "dtype": "float32"}}
    ctx = SimpleNamespace(calls=[call], whole=True,
                          config={"h": 1024, "w": 1024})
    shapes = level_shapes(1024, 1024)
    one = sum(stencil_bound(n, 1, *shapes[lv], "float32")["bound_ms"]
              for lv in (0, 1)
              for n in ("presmooth_restrict", "prolong_postsmooth"))
    one += stencil_bound("vcycle", 1, *shapes[2], "float32")["bound_ms"]
    traced_ms = (36 * 10.0 + 9 * 50.0) / 1e3
    assert layers.stencil_roofline(ctx) == pytest.approx(
        100 * 9 * one / traced_ms)
    assert layers.cg_iterations(ctx) == 8
    assert layers.kernels_per_iteration(ctx) == pytest.approx(45 / 8)
    call["counters"] = {**counters, "jacobi_sweeps": 3}
    assert layers.stencil_roofline(ctx) is None  # another route
