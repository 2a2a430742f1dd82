"""In a fresh interpreter: the harness, its drivers, metrics and roofline
load no JAX and no JAX package (by whole top-level name), and the plain
references load nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import HOME, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "nodal_tpu"}


def _loaded(code: str) -> set[str]:
    proc = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(HOME)!r}]\n"
            "from portbench.spec import Bench\n"
            "from portbench import runner, trace\n"
            f"b = Bench({str(ROOT)!r}, {str(HOME)!r})\n"
            "for w in b.workload_names():\n"
            "    c = b.cell(w)\n"
            "    [b.metric(m['name']) for m in c.end_to_end + c.per_layer]\n"
            "import nodal_tpu_torch, nodal_tpu_torch.ops.grid\n")
    loaded = _loaded(code)
    assert "nodal_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = (f"import sys; sys.path[:0] = [{str(HOME)!r}]\n"
            "from reference import grid, mna, rows\n"
            "from roofline import bounds, peaks\n")
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {"nodal_tpu_torch"})
