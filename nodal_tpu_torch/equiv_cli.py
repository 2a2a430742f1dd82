"""``nodal-resistance`` command line: two-point equivalent resistance.

    python -m nodal_tpu_torch.equiv_cli FILE [-s] [--native on]
        [--nodes A B] [--device cpu]

Counterpart of ``nodal_tpu/equiv_cli.py``.  Parity target: reference
equiv.py:64-89 — probe nodes ``1`` and ``g`` unless ``--nodes`` says
otherwise, the same error messages and exit codes, the same ``R = ...``
line.  ``--device`` picks where the solve runs (default ``cuda``);
``-s/--sparse`` solves through the sparse backend, and ``--native`` parses
with the C++ parser and injects the probe straight into the sparse solve
(``auto``: netlists over 256 KiB).
"""

from __future__ import annotations

import argparse
import sys

from nodal_tpu_torch.solver_cli import _DTYPES, torch_dtype, wants_native


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
        help="use the sparse/iterative backend",
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
    parser.add_argument(
        "--native",
        choices=("auto", "on", "off"),
        default="auto",
        help="use the C++ netlist parser + direct sparse solve (auto: for "
        "netlists over 256 KiB)",
    )
    return parser


def _native(args) -> float:
    """Native path: C++ parse -> stamp tensors -> the probe injected into
    the sparse solve on ``--device``."""
    from nodal_tpu_torch.equiv import equivalent_resistance_stamps
    from nodal_tpu_torch.utils import native

    with open(args.netlist_path, "rb") as fh:
        try:
            stamps, symbols = native.parse_stamps(fh.read())
        except NotImplementedError:
            # OPAMP rows: a non-resistive netlist, as a ValueError.
            raise ValueError("Network is not resistive") from None
    if not symbols.all_resistive:
        raise ValueError("Network is not resistive")
    ia = symbols.node_index(args.nodes[0])
    ib = symbols.node_index(args.nodes[1])
    return equivalent_resistance_stamps(
        stamps, ia, ib, dtype=torch_dtype(args.dtype), device=args.device)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from nodal_tpu_torch import Netlist
    from nodal_tpu_torch.equiv import (NotConvergedError,
                                       equivalent_resistance)

    netlist = None
    if not wants_native(args):
        try:
            netlist = Netlist(args.netlist_path)
        except FileNotFoundError:
            sys.exit(1)
    try:
        if netlist is None:
            r = _native(args)
        else:
            r = equivalent_resistance(
                netlist, args.nodes[0], args.nodes[1], sparse=args.sparse,
                dtype=torch_dtype(args.dtype), device=args.device,
            )
    except NotConvergedError as e:
        print("Solver error\n")
        print(e.args[0])
        sys.exit(1)
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
