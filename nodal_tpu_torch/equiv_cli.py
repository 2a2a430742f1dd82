"""``nodal-resistance`` command line: two-point equivalent resistance.

    python -m nodal_tpu_torch.equiv_cli FILE [--nodes A B] [--device cpu]

Counterpart of ``nodal_tpu/equiv_cli.py``.  Parity target: reference
equiv.py:64-89 — probe nodes ``1`` and ``g`` unless ``--nodes`` says
otherwise, the same error messages and exit codes, the same ``R = ...``
line.  ``--device`` picks where the solve runs (default ``cuda``);
``-s/--sparse`` ends in a usage error: the sparse backend is not ported
yet.
"""

from __future__ import annotations

import argparse
import sys

from nodal_tpu_torch.circuit import SPARSE_NOT_PORTED
from nodal_tpu_torch.solver_cli import _DTYPES, torch_dtype


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Calculate equivalent resistance using nodal analysis\n"
        "Label nodes as '1' and 'g' to mark where to connect to the network."
    )
    parser.add_argument(
        "netlist_path",
        metavar="FILE",
        help="csv file describing the resistive network",
    )
    parser.add_argument(
        "-s", "--sparse", action="store_true",
        help=f"the sparse/iterative backend: {SPARSE_NOT_PORTED}",
    )
    parser.add_argument(
        "--nodes",
        nargs=2,
        metavar=("A", "B"),
        default=("1", "g"),
        help="probe node pair (default: 1 g)",
    )
    parser.add_argument(
        "--dtype", choices=_DTYPES, default="f64",
        help="numeric precision (default f64)",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the solve runs (default cuda)",
    )
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.sparse:
        parser.error(f"-s/--sparse is {SPARSE_NOT_PORTED}")

    from nodal_tpu_torch import Netlist
    from nodal_tpu_torch.equiv import equivalent_resistance

    try:
        netlist = Netlist(args.netlist_path)
    except FileNotFoundError:
        sys.exit(1)

    try:
        r = equivalent_resistance(
            netlist, args.nodes[0], args.nodes[1],
            dtype=torch_dtype(args.dtype), device=args.device,
        )
    except ValueError:
        print("Invalid netlist\n")
        print("Resistors are the only component allowed in the circuit")
        sys.exit(1)
    except KeyError as e:
        print("Invalid netlist\n")
        print(e.args[0])
        sys.exit(1)

    print(f"R = {r}")


if __name__ == "__main__":
    main()
