"""lu_roofline: the blocked-LU kernels' share of their roofline, %: the
least time of a call's factorizations and substitutions
(``roofline/block_lu.py`` at the solve's recorded shape, in the dtype the
kernels' names carry: a factorization by its operations at the f32 CUDA
cores' 67 TFLOP/s, a substitution by its bytes at 3.35 TB/s) over the
traced time of the library's ``block_lu_*`` kernels.  Nothing unless the
trace is whole and holds as many of the kernels as the call counted
(randnet1k.mc4k; moves solves_per_s)."""

from roofline.block_lu import lu_factor_bound, lu_substitution_bound


def read(ctx):
    if not ctx.calls or not ctx.whole:
        return None
    bound_ms = traced_ms = 0.0
    for call in ctx.calls:
        c = call["counters"]
        ops = [op for op in call["kernels"]
               if op[4] and "block_lu" in op[0]]
        shape = c.get("lu_shape")
        if not ops or shape is None or len(ops) != c.get("lu_kernels"):
            return None
        dtype = "float64" if "double" in ops[0][0] else "float32"
        B, n, r = shape
        bound_ms += (c["lu_factorizations"]
                     * lu_factor_bound(B, n, dtype)["bound_ms"]
                     + c["lu_substitutions"]
                     * lu_substitution_bound(B, n, r, dtype)["bound_ms"])
        traced_ms += sum(op[2] for op in ops) / 1e3
    return 100.0 * bound_ms / traced_ms
