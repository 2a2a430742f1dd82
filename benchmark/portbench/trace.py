"""A ``torch.profiler`` trace of a run's traced calls, reduced to what the
per-layer readers read.

Each traced call runs inside a ``record_function`` span of its own.  A
device operation belongs to the call whose span holds the host call that
launched it (the two share a ``correlation``), so the device clock's skew
cannot move it into a neighbouring call.  A kernel whose launch has no
PyTorch operator (``aten::``) as its innermost host operator was launched
by the port's own kernel library through ``ctypes`` (inside an autograd
Function's forward, or outside any operator); every other kernel is
PyTorch's.  The traced window is the host span from the first traced
call's start to the last one's end, after its synchronise, so gaps before
a call's first launch count as idle.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
#: Host operators that are PyTorch's own; a kernel launched with one of
#: them innermost is PyTorch's, any other (an autograd Function's forward,
#: or none) the port's library's.
TORCH_OPS = ("aten::", "prim::", "c10d::")


class TraceError(RuntimeError):
    pass


def kernel_name(full: str) -> str:
    """A kernel's own name out of the profiler's demangled signature:
    ``void (anonymous namespace)::block_lu_gemm<float>(...)`` ->
    ``block_lu_gemm`` (``chip_smoke.py:kernel_name``)."""
    m = re.search(r"::(\w+)\s*[<(]", full) or re.search(r"(\w+)\s*[<(]", full)
    return m.group(1) if m else full


def record(run_call, labels: list[str]) -> list[dict]:
    """Profile ``run_call(label)`` for each label, each in its span, and
    return the trace's events.  The export goes to a temporary file under
    ``TMPDIR``, deleted once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label in labels:
            with record_function(label):
                run_call(label)
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)


class _Covering:
    """Which host events cover a time point, per thread."""

    def __init__(self, intervals):
        intervals.sort()
        self.starts = [iv[0] for iv in intervals]
        self.items = intervals
        self.max_end, top = [], float("-inf")
        for iv in intervals:
            top = max(top, iv[1])
            self.max_end.append(top)

    def innermost(self, t: float):
        """The covering event that started last, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0 or self.max_end[i] < t:
            return None
        while self.items[i][1] < t:
            i -= 1
        return self.items[i]


class Trace:
    """The traced calls ``labels`` out of a trace's ``events``.

    ``calls[label]`` lists the call's device operations as
    ``(name, start_us, dur_us, cat, lib)``; ``window_us`` and ``busy_us``
    are the traced window and the time in it with an operation on the
    device; ``gaps`` the idle intervals of the window.
    """

    def __init__(self, events: list[dict], labels: list[str]):
        spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") in labels}
        if len(spans) != len(labels):
            raise TraceError(f"spans {sorted(spans)} in the trace, expected "
                             f"{labels}")
        order = sorted(labels, key=lambda k: spans[k][0])
        starts = [spans[k][0] for k in order]

        def span_of(t):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[order[i]][1]:
                return order[i]
            return None

        ops, host = {}, {}
        launches = {}
        for e in events:
            cat = e.get("cat")
            if cat in HOST_CATS and "dur" in e:
                iv = (e["ts"], e["ts"] + e["dur"], e.get("name", ""))
                host.setdefault(e.get("tid"), []).append(iv)
                if cat == "cpu_op":
                    ops.setdefault(e.get("tid"), []).append(iv)
            if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (e["ts"], e.get("tid"))
        in_op = {tid: _Covering(iv) for tid, iv in ops.items()}
        self._host = {tid: _Covering(iv) for tid, iv in host.items()}

        self.calls = {label: [] for label in labels}
        device = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            corr = e.get("args", {}).get("correlation")
            t, tid = launches.get(corr, (e["ts"], None))
            label = span_of(t)
            if label is None:
                continue
            cover = in_op.get(tid)
            op = cover.innermost(t) if cover is not None else None
            lib = e["cat"] == "kernel" and (
                op is None or not op[2].startswith(TORCH_OPS))
            item = (e.get("name", ""), e["ts"], e["dur"], e["cat"], lib)
            self.calls[label].append(item)
            device.append((e["ts"], e["ts"] + e["dur"]))

        t0 = min(spans[k][0] for k in labels)
        t1 = max(spans[k][1] for k in labels)
        self.window_us = t1 - t0
        busy, gaps, cursor = 0.0, [], t0
        for s, f in sorted(device):
            s, f = max(s, t0), min(f, t1)
            if f <= cursor:
                continue
            if s > cursor:
                gaps.append((cursor, s))
                cursor = s
            busy += f - cursor
            cursor = f
        if cursor < t1:
            gaps.append((cursor, t1))
        self.busy_us = busy
        self.gaps = gaps
        self._main_tid = max(host, key=lambda tid: len(host[tid])) \
            if host else None

    def kernels(self, label: str) -> list[tuple]:
        return [op for op in self.calls[label] if op[3] == "kernel"]

    def idle_share(self) -> float | None:
        """Share of the traced window with nothing on the device, %."""
        if self.window_us <= 0:
            return None
        return 100.0 * (1.0 - self.busy_us / self.window_us)

    def top_device_ops(self, n: int = 10) -> list[list]:
        """The device operations that took most time, by kernel name,
        seconds summed over the traced calls."""
        total = {}
        for ops in self.calls.values():
            for name, _, dur, cat, _ in ops:
                key = kernel_name(name) if cat == "kernel" else cat
                total[key] = total.get(key, 0.0) + dur / 1e6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list[list]:
        """Idle time of the traced window, seconds, by what the host was
        doing at each gap's middle: the innermost torch operator or CUDA
        runtime call on the host thread that launched the work, or
        ``python`` where none was running."""
        cover = self._host.get(self._main_tid)
        total = {}
        for s, f in self.gaps:
            hit = cover.innermost((s + f) / 2) if cover else None
            key = hit[2] if hit else "python"
            total[key] = total.get(key, 0.0) + (f - s) / 1e6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]
