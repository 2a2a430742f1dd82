"""What the per-layer readers read from the program's own spans and
counters (``nodal_tpu_torch.utils.tracing``), which record each traced
call while ``torch.profiler`` runs.

The traced calls of the run's last profiler attempt are the newest call
records: the lead-in call precedes them, and nothing after them runs
under the profiler.  Each function returns None when the run was not
traced, when the program has no tracing module (an older checkout), or
when the newest records are not one a traced call, each a root of the
expected name.
"""

from __future__ import annotations

SWEEP_ROOT = "batch.call"
GRID_ROOT = "grid.solve"


def traced_calls(ctx, root: str):
    """The call records of the traced calls, oldest first, or None."""
    if not ctx.calls:
        return None
    try:
        from nodal_tpu_torch.utils import tracing
    except ImportError:
        return None
    calls = tracing.recent(len(ctx.calls))
    if len(calls) != len(ctx.calls) or any(c.name != root for c in calls):
        return None
    return calls


def _mean_per_call(values):
    if None in values:
        return None
    return sum(values) / len(values)


def contract_ms(ctx):
    """Device ms a call in the contract layer's own work: the self time
    of its ``contract.run`` spans less their ``tier.solve`` spans."""
    calls = traced_calls(ctx, SWEEP_ROOT)
    if calls is None:
        return None
    from nodal_tpu_torch.utils.tracing import self_ms

    values = []
    for call in calls:
        runs = [self_ms(call, s, device=True)
                for s in call.find("contract.run")]
        values.append(sum(runs) if runs and None not in runs else None)
    return _mean_per_call(values)


def assemble_ms(ctx):
    """Device ms a call in ``band.assemble`` spans, summed over them."""
    calls = traced_calls(ctx, SWEEP_ROOT)
    if calls is None:
        return None
    values = []
    for call in calls:
        ms = [s.device_ms for s in call.find("band.assemble")]
        values.append(sum(ms) if ms and None not in ms else None)
    return _mean_per_call(values)


def contract_passes(ctx):
    """Defect passes a call (the ``contract_passes`` counter)."""
    calls = traced_calls(ctx, SWEEP_ROOT)
    if calls is None:
        return None
    return _mean_per_call([c.counters.get("contract_passes")
                           for c in calls])


def issue_ms_per_iteration(ctx):
    """Mean host ms of a ``cg.iteration`` span over the traced calls:
    the time to issue one iteration's work."""
    calls = traced_calls(ctx, GRID_ROOT)
    if calls is None:
        return None
    spans = [c.find("cg.iteration") for c in calls]
    if not all(spans):
        return None
    return (sum(s.host_ms for its in spans for s in its)
            / sum(len(its) for its in spans))


def sync_wait_ms(ctx):
    """Host ms a call blocked in its ``cg.sync`` spans."""
    calls = traced_calls(ctx, GRID_ROOT)
    if calls is None:
        return None
    values = []
    for call in calls:
        ms = [s.host_ms for s in call.find("cg.sync")]
        values.append(sum(ms) if ms else None)
    return _mean_per_call(values)


def host_syncs_per_iteration(ctx):
    """The ``host_syncs`` counter over the ``cg.iteration`` spans, summed
    over the traced calls."""
    calls = traced_calls(ctx, GRID_ROOT)
    if calls is None:
        return None
    syncs = [c.counters.get("host_syncs") for c in calls]
    its = [len(c.find("cg.iteration")) for c in calls]
    if None in syncs or not all(its):
        return None
    return sum(syncs) / sum(its)
