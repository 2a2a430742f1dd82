"""setup_s: seconds from process start to the first timed call: imports,
the kernel library's load (its nvcc build on a checkout's first run),
the circuit's compile and plans, the inputs, the warm-up calls."""


def read(ctx):
    return ctx.setup_s
