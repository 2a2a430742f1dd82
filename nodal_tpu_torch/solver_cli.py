"""``nodal-solver`` command line: solve a CSV netlist and print the solution.

    python -m nodal_tpu_torch.solver_cli FILE [--device cpu] [--stats]

Counterpart of ``nodal_tpu/solver_cli.py``.  Parity target: reference
solver.py — the same positional netlist path, exit codes (missing file →
1, unconnected circuit → 1) and printed format.  ``--device`` picks where
the solve runs (default ``cuda``).  ``-s/--sparse`` is accepted for parity
but ends in a usage error: the sparse backend is not ported yet.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

from nodal_tpu_torch.circuit import SPARSE_NOT_PORTED

_DTYPES = ("f32", "f64")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Solve electrical circuits using nodal analysis"
    )
    parser.add_argument(
        "netlist_path", metavar="FILE", help="csv file describing the netlist"
    )
    parser.add_argument(
        "-s", "--sparse", action="store_true",
        help=f"the sparse/iterative backend: {SPARSE_NOT_PORTED}",
    )
    parser.add_argument(
        "--dtype", choices=_DTYPES, default="f64",
        help="numeric precision (default f64)",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the solve runs (default cuda)",
    )
    parser.add_argument(
        "--stats", action="store_true", help="print timing statistics to stderr"
    )
    parser.add_argument(
        "--compat-vccs",
        action="store_true",
        help="stamp VCCS with VCVS semantics, bit-matching upstream nodal "
        "(whose dispatcher routes VCCS to its VCVS stamp); default is "
        "correct transconductance semantics",
    )
    parser.add_argument(
        "--sensitivity",
        metavar="TARGET",
        default=None,
        help="also print d TARGET / d value for every component, where "
        "TARGET is an output quantity as printed, e.g. 'e(2)' or 'i(v1)' "
        "— computed by the adjoint method (one extra solve total, not one "
        "per component)",
    )
    return parser


def torch_dtype(name: str):
    """``"f32"`` / ``"f64"`` -> the torch dtype."""
    import torch

    return {"f32": torch.float32, "f64": torch.float64}[name]


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.sparse:
        parser.error(f"-s/--sparse is {SPARSE_NOT_PORTED}")

    from nodal_tpu_torch import Circuit, Netlist, Quirks, UnconnectedCircuitError

    t0 = time.perf_counter()
    try:
        netlist = Netlist(args.netlist_path)
    except FileNotFoundError:
        sys.exit(1)
    t1 = time.perf_counter()

    quirks = Quirks(vccs_as_vcvs=True) if args.compat_vccs else None
    circuit = Circuit(netlist, dtype=torch_dtype(args.dtype), quirks=quirks,
                      device=args.device)
    try:
        solution = circuit.solve()
    except UnconnectedCircuitError:
        sys.exit(1)
    t2 = time.perf_counter()

    print(solution)
    if args.sensitivity is not None:
        m = re.fullmatch(r"([ei])\((.+)\)", args.sensitivity.strip())
        if m is None:
            print(f"bad --sensitivity target {args.sensitivity!r}: "
                  "expected e(<node>) or i(<component>)", file=sys.stderr)
            sys.exit(1)
        from nodal_tpu_torch.batch import sensitivities

        kind, name = m.group(1), m.group(2)
        try:
            sens = sensitivities(
                circuit,
                **({"potential": name} if kind == "e"
                   else {"current": name}),
            )
        except KeyError as exc:
            print(f"--sensitivity: {exc.args[0]}", file=sys.stderr)
            sys.exit(1)
        print(f"Sensitivities of {kind}({name}):")
        for comp in sorted(sens):
            print(f"d/d({comp}) \t= {sens[comp]}")
    if args.stats:
        s = solution.stats
        print(
            f"parse: {t1 - t0:.4f}s  compile+solve: {t2 - t1:.4f}s"
            f"  method: {s['method']}  residual: {s['residual']:.2e}",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
