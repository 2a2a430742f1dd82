"""thomas_roofline: the block-Thomas kernels' share of their roofline, %:
the least time of a call's solves (``roofline/block_thomas.py`` at the
shape the wrapper recorded, in the dtype the kernels' names carry; a
solve is ``launch_plan``'s host loops at that shape) over the traced time
of the library's block-Thomas kernels.  Bound by operations over the f32
CUDA cores' 67 TFLOP/s at the lattice's shape.  Nothing unless the trace
is whole and holds as many of the kernels as the wrapper counted
(lattice2k.mc1k; moves solves_per_s)."""

from roofline.block_thomas import block_thomas_bound
from roofline.bounds import ITEMSIZE


def read(ctx):
    if not ctx.calls or not ctx.whole:
        return None
    from nodal_tpu_torch.ops.block_thomas import MAX_R, launch_plan

    bound_ms = traced_ms = 0.0
    for call in ctx.calls:
        c = call["counters"]
        ops = [op for op in call["kernels"]
               if op[4] and "block_thomas" in op[0]]
        shape = c.get("thomas_shape")
        if not ops or shape is None or len(ops) != c["thomas_kernels"]:
            return None
        dtype = "float64" if "double" in ops[0][0] else "float32"
        B, nb, kb, r = shape
        loops = launch_plan(B, nb, kb, min(r, MAX_R),
                            ITEMSIZE[dtype]).calls * -(-r // MAX_R)
        solves, rest = divmod(c["thomas"], loops)
        if rest:
            return None
        bound_ms += solves * block_thomas_bound(*shape, dtype)["bound_ms"]
        traced_ms += sum(op[2] for op in ops) / 1e3
    return 100.0 * bound_ms / traced_ms
