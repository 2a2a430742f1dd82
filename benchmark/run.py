"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python benchmark/run.py --workload mesh1k.mc16k --seed 7 --seconds 20 \
        --trace 0

prints a few lines of JSON about the run and, as its last line, the
result: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` with ``--trace 1``, and last ``compared``, each number the
check compared with its limit (also the last lines on standard error).
``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` runs the cell's traced calls under
``torch.profiler`` and reports its per-layer metrics.  ``--control 1``
puts the check's control (a lower precision) in the program's place.

It measures ``nodal_tpu_torch`` from this checkout on the card, and fails
without a CUDA device or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HOME = Path(__file__).resolve().parent
ROOT = HOME.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Build and kernel caches at fixed paths inside the checkout.
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path[:0] = [str(ROOT), str(HOME)]

    import torch

    spans = {"import_torch_s": time.perf_counter() - T0}
    from portbench import runner
    from portbench.spec import Bench

    bench = Bench(ROOT, HOME)
    cell = bench.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}: no result",
              file=sys.stderr)
        return 2
    t = time.perf_counter()
    import nodal_tpu_torch

    spans["import_port_s"] = time.perf_counter() - t
    where = Path(nodal_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        print(f"portbench: nodal_tpu_torch was loaded from {where}, not from "
              f"this checkout: no result", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    return runner.run(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), control=bool(args.control), t0=T0,
                      spans=spans)


if __name__ == "__main__":
    sys.exit(main())
