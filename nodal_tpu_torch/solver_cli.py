"""``nodal-solver`` command line: solve a CSV netlist and print the solution.

    python -m nodal_tpu_torch.solver_cli FILE [-s] [--native on]
        [--device cpu] [--stats]

Counterpart of ``nodal_tpu/solver_cli.py``.  Parity target: reference
solver.py — the same positional netlist path, exit codes (missing file →
1, unconnected circuit → 1) and printed format.  ``--device`` picks where
the solve runs (default ``cuda``).  ``-s/--sparse`` solves through the
sparse backend: a resistive circuit by CG (the skyline LDLᵀ on the CPU),
any other by ideal-source reduction and bordered elimination.
``--native`` parses with the C++ parser and solves sparsely (``auto``:
netlists over 256 KiB); a solve that does not converge goes on to the
Python path.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

import numpy as np

_DTYPES = ("f32", "f64")

#: ``--native auto`` takes netlists of at least this many bytes.
_NATIVE_SIZE_THRESHOLD = 256 * 1024


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Solve electrical circuits using nodal analysis"
    )
    parser.add_argument(
        "netlist_path", metavar="FILE", help="csv file describing the netlist"
    )
    parser.add_argument(
        "-s", "--sparse", action="store_true",
        help="use the sparse backend (CG on resistive circuits; ideal-"
        "source reduction and bordered elimination on circuits with "
        "voltage or controlled sources)",
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
        "--native",
        choices=("auto", "on", "off"),
        default="auto",
        help="use the C++ netlist parser + sparse solve for large netlists "
        "(auto: over 256 KiB)",
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


def wants_native(args) -> bool:
    """Whether ``--native`` asks for the C++ parser on this file (``auto``:
    files of at least ``_NATIVE_SIZE_THRESHOLD`` bytes); never for a
    missing file, which the Python path reports."""
    if args.native == "off":
        return False
    try:
        size = os.path.getsize(args.netlist_path)
    except OSError:
        return False
    return args.native == "on" or size >= _NATIVE_SIZE_THRESHOLD


def _try_native(args) -> bool:
    """Native path: C++ parse -> stamp tensors -> sparse solve on
    ``--device`` (the bordered elimination for a netlist with branch rows)
    -> print.  Returns False, having printed nothing, for a solve that did
    not converge: the Python path, with its rescue and its singularity
    diagnosis, takes those."""
    from nodal_tpu_torch.models.stamps import Quirks
    from nodal_tpu_torch.ops.sparse import solve_sparse_system
    from nodal_tpu_torch.utils import native

    quirks = Quirks(vccs_as_vcvs=True) if args.compat_vccs else None
    t0 = time.perf_counter()
    with open(args.netlist_path, "rb") as fh:
        stamps, symbols = native.parse_stamps(fh.read(), quirks=quirks)
    t1 = time.perf_counter()
    x, info = solve_sparse_system(stamps, stamps.params,
                                  dtype=torch_dtype(args.dtype),
                                  device=args.device)
    x = x.double().cpu().numpy()
    if not info.converged or not np.all(np.isfinite(x)):
        return False
    t2 = time.perf_counter()

    lines = [f"Ground node: {symbols.ground}"]
    for name, row in sorted(symbols.node_rows()):
        lines.append(f"e({name}) \t= {x[row]}")
    for name, row in sorted(symbols.anomalous_rows()):
        lines.append(f"i({name}) \t= {x[row]}")
    print("\n".join(lines))
    if args.stats:
        print(
            f"parse: {t1 - t0:.4f}s  compile+solve: {t2 - t1:.4f}s  "
            f"method: native+{info.method}  residual: {info.residual:.2e}  "
            f"iterations: {info.iterations}",
            file=sys.stderr,
        )
    return True


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.sensitivity is None and wants_native(args) and _try_native(args):
        return

    from nodal_tpu_torch import Circuit, Netlist, Quirks, UnconnectedCircuitError

    t0 = time.perf_counter()
    try:
        netlist = Netlist(args.netlist_path)
    except FileNotFoundError:
        sys.exit(1)
    t1 = time.perf_counter()

    quirks = Quirks(vccs_as_vcvs=True) if args.compat_vccs else None
    circuit = Circuit(netlist, sparse=args.sparse,
                      dtype=torch_dtype(args.dtype), quirks=quirks,
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
            f"  method: {s['method']}  residual: {s['residual']:.2e}"
            + (f"  iterations: {s['iterations']}" if "iterations" in s
               else ""),
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
