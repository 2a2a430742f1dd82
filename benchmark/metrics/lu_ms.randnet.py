"""lu_ms.randnet: device ms a traced call spends in the blocked LU, the
program's ``lu.factor`` and ``lu.solve`` spans (CUDA events) summed; None
where the program has no such span (randnet1k.mc4k; moves
solves_per_s)."""

from portbench.spans import SWEEP_ROOT, traced_calls


def read(ctx):
    calls = traced_calls(ctx, SWEEP_ROOT)
    if calls is None:
        return None
    values = []
    for call in calls:
        ms = [s.device_ms for s in call.find("lu.factor")
              + call.find("lu.solve")]
        if not ms or None in ms:
            return None
        values.append(sum(ms))
    return sum(values) / len(values)
