"""The transfer kernels' decomposition (``presmooth_restrict_strip``,
``prolong_postsmooth_strip`` in ``nodal_tpu_torch/csrc/stencil.cu``),
emulated in torch in the kernels' order, against the plain versions of
``nodal_tpu_torch/ops/stencil.py`` and the Pallas kernels of
``nodal_tpu/ops/pallas_stencil.py`` in interpret mode; and the host plan
the wrappers launch them with (``stencil.strip_plan``).

The emulation runs every block of a launch at once: column strips of
``STRIP_COLS`` coarse columns, row segments from the plan, a ring of
``RING_GROUPS`` slots of two fine rows (and, for the prolongation, one
coarse row) that each stage copies into and reads from as the kernel does,
rows past the field's edges copied from their mirror rows, ghost columns
written only by the edge strips one group ahead, and each "thread" (coarse
column) holding its rows in registers.  Ring cells the kernel never writes
start as NaN, so an output that reads one fails.

Tolerances: against the plain versions f32 atol 1e-5·max|input| (the
kernel's fused multiply-adds aside, the same operations in the same
order) and f64 1e-12·max|input|; against the Pallas kernels, which form
the transfers as matrix products, f32 1e-5·max|input|, as
``tests/test_torch_stencil.py`` holds the plain versions to them.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nodal_tpu.ops import pallas_stencil as jps  # noqa: E402
from nodal_tpu_torch.ops import stencil  # noqa: E402
from nodal_tpu_torch.utils import kernels  # noqa: E402

#: Ring slots of the kernels (``kRingGroups``).
RING_GROUPS = 4
#: SMs of the H100 the plans are taken for.
SMS = 132

# Shapes whose strip and segment seams fall off powers of two: a batch of
# 3 with a partial second strip and 86 segments of 6 rows (the last 5),
# 17 strips of three one-row segments, one strip of 512 two-row
# segments, the grid path's 1022² (128 segments, the last of 3 rows; the
# narrow path in f32), and the smallest field.
SHAPES = [(3, 1030, 262), (1, 6, 4100), (1, 2048, 6), (1, 1022, 1022),
          (1, 2, 2)]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many tiny torch ops: one intra-op thread keeps them fast beside the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(seed, *shapes, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(dtype))
            for s in shapes]


def _reflect(q, n):
    return torch.where(q < 0, -1 - q, torch.where(q >= n, 2 * n - 1 - q, q))


class _Launch:
    """Every block of one strip launch: batch index, first coarse column
    J0, first coarse row I0 and rows nI of each, with the plan's halo."""

    def __init__(self, B, h, w, plan, itemsize):
        C = stencil.STRIP_COLS
        b, sx, sy = torch.meshgrid(torch.arange(B),
                                   torch.arange(plan.strips),
                                   torch.arange(plan.segments),
                                   indexing="ij")
        self.b, self.sx = b.reshape(-1), sx.reshape(-1)
        self.J0 = C * self.sx
        self.c0 = 2 * self.J0
        self.I0 = plan.segment * sy.reshape(-1)
        self.nI = torch.clamp(h // 2 - self.I0, max=plan.segment)
        self.h, self.w = h, w
        self.left = self.sx == 0
        self.right = self.sx == plan.strips - 1
        values = 16 // itemsize if plan.wide else 1
        self.H = max(values, 2)
        self.W = 2 * C + 2 * self.H
        self.j = torch.arange(C)

    def ring(self, rows, width, dtype):
        return torch.full((len(self.b), rows, width), float("nan"),
                          dtype=dtype)

    def stage(self, ring, slot, field, q, active):
        """Fine rows q (one a block) into ring rows ``slot`` of the active
        blocks: the values inside [0, w) only."""
        cols = self.c0[:, None] - self.H + torch.arange(self.W)
        inside = (cols >= 0) & (cols < self.w) & active[:, None]
        q = torch.where(active, q, 0)  # an idle block copies nothing
        rows = field[self.b, _reflect(q, self.h)]
        vals = torch.gather(rows, 1, cols.clamp(0, self.w - 1))
        ring[:, slot] = torch.where(inside, vals, ring[:, slot])

    def stage_coarse(self, ring, slot, zc, Q, active):
        hc, wc = self.h // 2, self.w // 2
        cols = self.J0[:, None] - 1 + torch.arange(stencil.STRIP_COLS + 2)
        inside = (cols >= 0) & (cols < wc) & active[:, None]
        Q = torch.where(active, Q, 0)
        rows = zc[self.b, _reflect(Q, hc)]
        vals = torch.gather(rows, 1, cols.clamp(0, wc - 1))
        ring[:, slot] = torch.where(inside, vals, ring[:, slot])

    def mirror(self, ring, slot, active):
        """The edge strips' ghost columns -1, -2 and w, w + 1 of ring rows
        ``slot``, from the landed row itself."""
        H = self.H
        n = torch.arange(len(self.b))
        left = n[self.left & active]
        ring[left, slot, H - 1] = ring[left, slot, H]
        ring[left, slot, H - 2] = ring[left, slot, H + 1]
        right = n[self.right & active]
        e = self.w - self.c0[right] + H
        ring[right, slot, e] = ring[right, slot, e - 1]
        ring[right, slot, e + 1] = ring[right, slot, e - 2]

    def mirror_coarse(self, ring, slot, active):
        wc = self.w // 2
        n = torch.arange(len(self.b))
        left = n[self.left & active]
        ring[left, slot, 0] = ring[left, slot, 1]
        right = n[self.right & active]
        e = wc - self.J0[right] + 1
        ring[right, slot, e] = ring[right, slot, e - 1]

    def read6(self, ring, slot):
        """Each thread's fine columns 2J - 2 .. 2J + 3: six [blocks, C]."""
        C, s = stencil.STRIP_COLS, self.H - 2
        # Copies: registers do not follow the ring's later writes.
        return [ring[:, slot, s + t:s + t + 2 * C:2].clone()
                for t in range(6)]


def _restrict4(f0, f1, f2, f3):
    return 0.75 * (f1 + f2) + 0.25 * (f0 + f3)


def _lap_point(v, up, dn, lf, rt, weight):
    return weight * (4.0 * v - (((up + dn) + lf) + rt))


def emulate_presmooth_restrict(r, x=None, *, weight=1.0, omega=0.8,
                               sms=SMS):
    """``presmooth_restrict_strip`` over the whole launch."""
    B, h, w = r.shape
    plan = stencil.strip_plan(B, h, w, r.element_size(), sms)
    L = _Launch(B, h, w, plan, r.element_size())
    c, D = omega / (4.0 * weight), RING_GROUPS
    Rr = L.ring(2 * D, L.W, r.dtype)
    Xr = L.ring(2 * D, L.W, r.dtype) if x is not None else None
    groups = L.nI + 2
    first = 2 * L.I0 - 2
    rc = torch.full((B, h // 2, w // 2), float("nan"), dtype=r.dtype)

    def stage(g):
        active = g < groups
        for e in range(2):
            s = 2 * (g % D) + e
            L.stage(Rr, s, r, first + 2 * g + e, active)
            if x is not None:
                L.stage(Xr, s, x, first + 2 * g + e, active)

    def fill(g):
        active = g < groups
        for e in range(2):
            L.mirror(Rr, 2 * (g % D) + e, active)
            if x is not None:
                L.mirror(Xr, 2 * (g % D) + e, active)

    def read(slot):
        r6 = L.read6(Rr, slot)
        x6 = L.read6(Xr, slot) if x is not None else [c * v for v in r6]
        return x6, r6[1:5]

    def residual_row(xu, xm, xd, rr):
        s = [rr[k] - _lap_point(xm[k + 1], xu[k], xd[k], xm[k], xm[k + 2],
                                weight) for k in range(4)]
        return _restrict4(*s)

    for g in range(D - 1):
        stage(g)
    fill(0)
    xu = xm = rm = h0 = h1 = None
    for g in range(int(groups.max())):
        fill(g + 1)
        stage(g + D - 1)
        s = 2 * (g % D)
        xa, ra = read(s)
        xq, rq = read(s + 1)
        if g > 0:
            ha = residual_row(xu, xm, xa[1:5], rm)
            hb = residual_row(xm[1:5], xa, xq[1:5], ra)
            if g > 1:
                J = L.J0[:, None] + L.j
                keep = (J < w // 2) & (g < groups)[:, None]
                I = (L.I0 + g - 2)[:, None].expand_as(J)
                rc[L.b[:, None].expand_as(J)[keep], I[keep], J[keep]] = \
                    _restrict4(h0, h1, ha, hb)[keep]
            h0, h1 = ha, hb
        xu, xm, rm = xa[1:5], xq, rq
    return rc


def emulate_prolong_postsmooth(r, zc, x=None, *, weight=1.0, omega=0.8,
                               sms=SMS):
    """``prolong_postsmooth_strip`` over the whole launch."""
    B, h, w = r.shape
    plan = stencil.strip_plan(B, h, w, r.element_size(), sms)
    L = _Launch(B, h, w, plan, r.element_size())
    c, D = omega / (4.0 * weight), RING_GROUPS
    Rr = L.ring(2 * D, L.W, r.dtype)
    Xr = L.ring(2 * D, L.W, r.dtype) if x is not None else None
    Zr = L.ring(D + 1, stencil.STRIP_COLS + 2, r.dtype)
    groups = L.nI + 1
    first = 2 * L.I0 - 1
    out = torch.full_like(r, float("nan"))

    def stage(g):
        active = g < groups
        for e in range(2):
            s = 2 * (g % D) + e
            L.stage(Rr, s, r, first + 2 * g + e, active)
            if x is not None:
                L.stage(Xr, s, x, first + 2 * g + e, active)
        L.stage_coarse(Zr, g % D, zc, L.I0 + g, active)
        if g == 0:
            L.stage_coarse(Zr, D, zc, L.I0 - 1, active)

    def fill(g):
        active = g < groups
        for e in range(2):
            L.mirror(Rr, 2 * (g % D) + e, active)
            if x is not None:
                L.mirror(Xr, 2 * (g % D) + e, active)
        L.mirror_coarse(Zr, g % D, active)
        if g == 0:
            L.mirror_coarse(Zr, D, active)

    def read3(slot):
        C = stencil.STRIP_COLS
        return [Zr[:, slot, t:t + C].clone() for t in range(3)]

    def form_x(slot, zn, zf):
        a = [0.75 * zn[k] + 0.25 * zf[k] for k in range(3)]
        p = [0.75 * a[0] + 0.25 * a[1], 0.75 * a[1] + 0.25 * a[0],
             0.75 * a[1] + 0.25 * a[2], 0.75 * a[2] + 0.25 * a[1]]
        r6 = L.read6(Rr, slot)
        if x is not None:
            x6 = L.read6(Xr, slot)
            X = [x6[k + 1] + p[k] for k in range(4)]
        else:
            X = [c * r6[k + 1] + p[k] for k in range(4)]
        return X, r6[2:4]

    def sweep(v, rr, up, dn, lf, rt):
        return v + c * (rr - _lap_point(v, up, dn, lf, rt, weight))

    def store(row, up, X, dn, rr, g):
        J = L.J0[:, None] + L.j
        keep = (J < w // 2) & (g < groups)[:, None]
        q = row[:, None].expand_as(J)
        b = L.b[:, None].expand_as(J)
        for k in (0, 1):
            val = sweep(X[k + 1], rr[k], up[k], dn[k], X[k], X[k + 2])
            out[b[keep], q[keep], (2 * J + k)[keep]] = val[keep]

    for g in range(D - 1):
        stage(g)
    fill(0)
    zo = xu = xm = rm = None
    for g in range(int(groups.max())):
        fill(g + 1)
        stage(g + D - 1)
        s = 2 * (g % D)
        if g == 0:
            zo = read3(D)
        zn = read3(g % D)
        Xa, ra = form_x(s, zo, zn)
        Xq, rq = form_x(s + 1, zn, zo)
        if g > 0:
            store(first + 2 * g - 1, xu, xm, Xa[1:3], rm, g)
            store(first + 2 * g, xm[1:3], Xa, Xq[1:3], ra, g)
        xu, xm, rm, zo = Xa[1:3], Xq, rq, zn
    return out


# ----------------------------------------------------------------- the plan

@pytest.mark.parametrize("B,h,w,itemsize,want", [
    # (wide, segment, strips, segments)
    (1, 1024, 1024, 4, (True, 4, 4, 128)),
    (1, 1022, 1022, 4, (False, 4, 4, 128)),   # pitch 4088 bytes: narrow
    (1, 1022, 1022, 8, (True, 4, 4, 128)),    # 8176 bytes
    (1, 512, 512, 4, (True, 1, 2, 256)),
    (1, 4096, 4096, 4, (True, 63, 16, 33)),
    (16, 1024, 1024, 4, (True, 57, 4, 9)),
    (1, 2, 2, 8, (True, 1, 1, 1)),
    (3, 1030, 262, 4, (False, 6, 2, 86)),
    (1, 6, 4100, 4, (True, 1, 17, 3)),
])
def test_strip_plan(B, h, w, itemsize, want):
    plan = stencil.strip_plan(B, h, w, itemsize, SMS)
    assert (plan.wide, plan.segment, plan.strips, plan.segments) == want
    hc, wc = h // 2, w // 2
    assert plan.strips * stencil.STRIP_COLS >= wc
    assert (plan.segments - 1) * plan.segment < hc <= \
        plan.segments * plan.segment
    assert plan.segments <= stencil.MAX_GRID_Y
    # A misaligned field takes the narrow path whatever its pitch.
    assert not stencil.strip_plan(B, h, w, itemsize, SMS, False).wide


def test_strip_plan_keeps_the_grid_within_its_limit():
    # So many SMs that the blocks alone would ask for 2,000,000 segments.
    plan = stencil.strip_plan(1, 2 * 2_000_000, 2, 4, 10**6)
    assert plan.segments <= stencil.MAX_GRID_Y
    assert plan.segments * plan.segment >= 2_000_000


# ------------------------------------------------------- the emulations


@pytest.mark.parametrize("B,h,w", SHAPES)
def test_presmooth_restrict_emulation_matches_plain(B, h, w):
    r64, x64 = _fields(h + w, (B, h, w), (B, h, w))
    for dtype in (torch.float32, torch.float64):
        r, x = r64.to(dtype), x64.to(dtype)
        for xs in (None, x):
            for weight in (1.0, 2.0):
                want = stencil.presmooth_restrict_plain(r, x=xs,
                                                        weight=weight)
                got = emulate_presmooth_restrict(r, xs, weight=weight)
                scale = float(r.abs().max()) + (
                    0.0 if xs is None else float(xs.abs().max()))
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=TOL[dtype] * scale)


@pytest.mark.parametrize("B,h,w", SHAPES)
def test_prolong_postsmooth_emulation_matches_plain(B, h, w):
    r64, x64, z64 = _fields(3 * h + w, (B, h, w), (B, h, w),
                            (B, h // 2, w // 2))
    for dtype in (torch.float32, torch.float64):
        r, x, zc = r64.to(dtype), x64.to(dtype), z64.to(dtype)
        for xs in (None, x):
            for weight in (1.0, 2.0):
                want = stencil.prolong_postsmooth_plain(r, zc, x=xs,
                                                        weight=weight)
                got = emulate_prolong_postsmooth(r, zc, xs, weight=weight)
                scale = max(float(t.abs().max()) for t in (r, zc, x))
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=TOL[dtype] * scale)


# 1022² f32 is past the Pallas kernels' single block and not a multiple of
# their 256-row tiles: held to the plain versions above only.
@pytest.mark.parametrize("B,h,w", [s for s in SHAPES if s[1:] != (1022, 1022)])
def test_transfer_emulations_match_pallas(B, h, w):
    r, zc = _fields(h * w + 5, (B, h, w), (B, h // 2, w // 2),
                    dtype=np.float32)
    rc = emulate_presmooth_restrict(r)
    out = emulate_prolong_postsmooth(r, zc)
    scale = max(float(r.abs().max()), float(zc.abs().max()))
    for k in range(B):
        want_rc = np.asarray(jps.fused_presmooth_restrict(
            jnp.asarray(r[k].numpy()), weight=1.0, omega=0.8))
        want_out = np.asarray(jps.fused_prolong_postsmooth(
            jnp.asarray(r[k].numpy()), jnp.asarray(zc[k].numpy()),
            weight=1.0, omega=0.8))
        np.testing.assert_allclose(rc[k].numpy(), want_rc, rtol=0,
                                   atol=1e-5 * float(r[k].abs().max()))
        np.testing.assert_allclose(out[k].numpy(), want_out, rtol=0,
                                   atol=1e-5 * scale)


def test_emulation_follows_the_kernel_source():
    """The ring depth, the strip width and the halo rule the emulation
    copies are the kernels'."""
    src = (kernels.CSRC_DIR / "stencil.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kRingGroups"]) == RING_GROUPS
    assert int(consts["kStripCols"]) == stencil.STRIP_COLS
    assert "kHalo = kV > 2 ? kV : 2;" in src
    assert "kCoarseWidth = kStripCols + 2;" in src


def test_ring_cells_never_copied_stay_unread():
    """Without the edge strips' ghost columns an output reads a cell the
    kernel never writes: the NaN start shows in the result."""
    (r,) = _fields(1, (1, 64, 64))
    mirror = _Launch.mirror
    try:
        _Launch.mirror = lambda self, ring, slot, active: None
        assert torch.isnan(emulate_presmooth_restrict(r)).any()
    finally:
        _Launch.mirror = mirror
    assert not torch.isnan(emulate_presmooth_restrict(r)).any()
