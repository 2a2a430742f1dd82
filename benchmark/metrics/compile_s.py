"""compile_s: seconds of the netlist compile and plans, the span around
``Circuit(Netlist.from_rows(rows))`` and ``BatchedSolver(...)``."""


def read(ctx):
    return ctx.setup.get("compile_s")
