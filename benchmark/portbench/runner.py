"""One run of one cell: set-up, the measured window or the traced calls,
the check against the plain reference, and the result line.

Every cell is a closed loop with one client: a call is issued only after
the previous call's result was synchronised, as a script that uses each
answer does.  The window runs calls while less than ``--seconds`` have
passed since it opened; its length is the time to the end of its last
call, so every call issued in it completed in it.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

from portbench import trace as tracing

#: Modules that no run may load: JAX and the JAX package, compared by
#: whole top-level name (the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "nodal_tpu")
#: Profiler sessions before the per-layer readers take a trace that is not
#: whole (the profiler at times loses events just after it starts).
TRACE_TRIES = 3


def emit(obj, out) -> None:
    print(json.dumps(obj), file=out, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() or None


def _window(drv, seconds: float, sync, err):
    """The measured window: (latencies, units, completed, failed, length)."""
    latencies, units, failed, k = [], 0, 0, 0
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < seconds:
        ts = time.perf_counter()
        try:
            out = drv.call(k)
            sync()
        except Exception:  # a failed call counts, and the loop goes on
            if not failed:
                traceback.print_exc(file=err)
            failed, out = failed + 1, None
        t_end = time.perf_counter()
        latencies.append(t_end - ts)
        if out is not None:
            drv.keep(k, out)
            units += drv.units
        k += 1
    return latencies, units, k - failed, failed, t_end - t_start


def _traced(drv, n_calls: int, sync, out, err):
    """The traced calls, in a ``torch.profiler`` session of their own after
    a lead-in call that is not read, retaken while the trace is not whole:
    each call's kernels of the port's library must be those its wrappers
    counted.  Returns (Trace, per-call records, labels, whole, failed)."""
    state = {"k": 0, "records": {}, "failed": 0}

    def run_call(label):
        k = state["k"]
        state["k"] += 1
        drv.reset_counters()
        ts = time.perf_counter()
        try:
            result = drv.call(k)
            sync()
        except Exception:  # a failed call counts, as in the window
            traceback.print_exc(file=err)
            state["failed"] += 1
            return
        te = time.perf_counter()
        counters = drv.counters()
        state["records"][label] = {
            "latency_s": te - ts, "counters": counters,
            "info": drv.describe(result, counters)}
        if label != "lead_in":
            drv.keep(k, result)

    labels = [f"portbench_call_{i}" for i in range(n_calls)]
    for attempt in range(TRACE_TRIES):
        drv.reset_kept()
        state["records"].clear()
        state["failed"] = 0
        events = tracing.record(run_call, ["lead_in"] + labels)
        tr = tracing.Trace(events, labels)
        why = None
        for label in labels:
            rec = state["records"].get(label)
            if rec is None:
                why = f"{label} failed"
                break
            lib = sum(1 for op in tr.kernels(label) if op[4])
            want = drv.expected_library_kernels(rec["counters"])
            if lib != want:
                why = (f"{label} traced {lib} kernels of the port's library, "
                       f"its wrappers launched {want}")
                break
        if why is None:
            return tr, state["records"], labels, True, state["failed"]
        emit({"trace_not_whole": why, "attempt": attempt}, out)
    return tr, state["records"], labels, False, state["failed"]


def run(bench, workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", control: bool = False, t0: float | None = None,
        spans: dict | None = None, out=None, err=None) -> int:
    """Run one cell and print its lines; returns the exit code.  ``spans``
    are set-up seconds already spent (imports), printed with the rest."""
    import torch

    out = out or sys.stdout
    err = err or sys.stderr
    t0 = time.perf_counter() if t0 is None else t0
    cell = bench.cell(workload)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    emit({"cell": workload, "seed": seed, "seconds": seconds,
          "trace": int(trace), "control": int(control), "device": device},
         out)

    spans = dict(spans or {})
    t = time.perf_counter()
    if cuda:
        torch.zeros(1, device=device)
        sync()
        spans["cuda_init_s"] = time.perf_counter() - t
        t = time.perf_counter()
    drv = cell.driver.Driver(cell.config, cell.traffic, seed, device,
                             control)
    spans["driver_s"] = time.perf_counter() - t
    t = time.perf_counter()
    drv.warm()
    sync()
    spans["warm_s"] = time.perf_counter() - t
    # Set-up's objects move where the collector no longer walks them, so a
    # full collection in the window walks only what the window made.
    t = time.perf_counter()
    gc.collect()
    gc.freeze()
    spans["gc_freeze_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    emit({"setup": {"setup_s": setup_s, **spans, **drv.spans}}, out)

    ctx = SimpleNamespace(config=cell.config, traffic=cell.traffic,
                          setup_s=setup_s, setup=dict(drv.spans),
                          window=None, trace=None, calls=None, whole=None)
    if trace:
        tr, records, labels, whole, failed = _traced(
            drv, int(cell.traffic["trace_calls"]), sync, out, err)
        attempted = len(labels)
        ctx.trace, ctx.whole = tr, whole
        ctx.calls = [{"kernels": tr.kernels(label), **records[label]}
                     for label in labels if label in records]
    else:
        latencies, units, completed, failed, length = _window(
            drv, seconds, sync, err)
        attempted = completed + failed
        ctx.window = SimpleNamespace(seconds=length, latencies_s=latencies,
                                     units=units, calls=completed)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()

    check = drv.collect()  # the sampled answers and inputs, on the host
    del drv
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    compared = check.compare()
    emit({"check": {"seconds": time.perf_counter() - t_check,
                    "answers": check.answers}}, out)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = bench.metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(attempted and not failed and all(
            v <= limit for _, v, limit in compared)),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device,
                   "kind": torch.cuda.get_device_name(0) if cuda else device,
                   "count": cell.chips, "memory_peak_bytes": peak}}
    if trace:
        result["device"]["busy_s"] = ctx.trace.busy_us / 1e6
        result["device"]["window_s"] = ctx.trace.window_us / 1e6
        result["breakdown"] = {"device_ops": ctx.trace.top_device_ops(),
                               "idle_gaps": ctx.trace.idle_by_host()}
    result["compared"] = {name: {"value": v, "limit": limit}
                          for name, v, limit in compared}
    if cuda:
        emit({"card": power_limit()}, out)

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=err)
        return 1
    print(json.dumps(result), file=out, flush=True)
    for name, v, limit in compared:
        print(f"compared {name} {v!r} limit {limit!r}", file=err, flush=True)
    return 0
