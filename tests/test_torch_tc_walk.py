"""The tc kernel's walk body (B4 at depth > 1, ``csrc/tc_walk_body.cuh``):
its host side on the CPU — the column walk, the fetch and sweep schedule,
the rings, the patches and their contraction from the depth-1 table's
fragments, the shared-memory layout, the planner's rules — and, on the
card, the kernel against its plain version (the port's ``tc`` at depth 2
and 3 against the JAX package is ``test_torch_tc.py``'s).

The replay mirrors the kernel in numpy (float64 arithmetic on the dtype's
layout: its 16-byte vectors, pitches, slots and MMA rows). Over every
column, each event of ``plan.walk_schedule`` stages planes into the input
ring (slot j mod P, rows congruent to the padded field's modulo 16 bytes)
or runs a sweep: each of its planes is cut into patches of ``rows`` lines
x 8 outputs (y rows of an 8-wide strip, or at rank 2 lifted, 8-wide row
segments), and every group of an operator in table order adds to the
patch's sums — a lone tap and the z arm at each output over the ring slot
of its plane, the x contraction as window lines times the band B, the y
contraction as the band's transpose A times window columns, A and B
rebuilt lane by lane from the table's fragment words as the MMAs read
them; a read past the source's rows or columns is zero, and outputs past
the region are not stored. Sweep s writes ring s's slot z mod (tau + 2rz)
(the substep's w' cut into the carry ring's slot z mod (tau + rz)), the
last sweep the output. Tolerances: against the plain version in float64
1e-6 in the f32 layout (the table rounds the band to f32), against
``ref.fused_stencil_tc_steps`` 1e-5 (f32) and 2e-2 (bf16) relative to the
largest |value|; on the card f32 1e-5, bf16 2e-2, a batched member equal
to its unbatched launch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis import audit_plan
from repro_torch.core import stencil as ts
from repro_torch.core.boundary import pad
from repro_torch.kernels import emit, ref
from repro_torch.kernels import plan as tplan
from repro_torch.kernels.ops import plan_for_nd
from repro_torch.kernels.phi import select_phi
from repro_torch.physics import diffusion as td
from repro_torch.physics import mhd as tm

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _plan(shape, order, depth, *, n_f=1, batch=None, dtype="float32",
          block=None, segments=None):
    """A tc walk plan for diffusion's operator (order ``order``) or, with
    ``n_f`` > 1, the derivative set's ``dxx``."""
    if n_f == 1:
        ops = td.DiffusionProblem(shape, accuracy=order).step_op(
            "hwc", device=CPU).ops
    else:
        ops = ts.derivative_operator_set(len(shape), order, 0.3)
    r = ops.radius_per_axis()
    lead = (n_f,) if batch is None else (batch, n_f)
    padded = lead + tuple(n + 2 * q * depth for n, q in zip(shape, r))
    plan = tplan.plan_stencil(ops, padded, n_f, strategy="tc", block=block,
                              dtype=dtype, fuse_steps=depth)
    if segments is not None:
        plan = dataclasses.replace(plan, segments=segments)
    assert plan.tc_walk and plan.walk and plan.persistent
    return ops, plan, padded


def _pair_plan(shape, block=None):
    """The f32 MHD pair (two fused-axpy substeps, aux w) on the tc walk."""
    solver = tm.MHDSolver(shape, device=CPU)
    ops = solver.operator_set
    padded = (8,) + tuple(n + 12 for n in shape)
    plan = plan_for_nd(ops, padded, 16, aux_shape=(8,) + tuple(
        n + 6 for n in shape), strategy="tc", block=block, fuse_steps=2,
        max_threads=256, n_slots=10)
    assert plan.tc_walk
    return solver, ops, plan


def _bf16_halves(words):
    """The low and high bfloat16 of each 32-bit word, as float64."""
    w = np.asarray(words, np.uint32)
    lo = ((w & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (w & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo.astype(np.float64), hi.astype(np.float64)


def _groups(ops, dtype, radii3):
    """Each operator's groups as the kernel reads them from
    ``emit.tc_table(ops, dtype, walk=True)``: ("lone", (dz, dy, dx), c),
    ("z", rest, coefficients), ("y", rest, A) with A the band's
    transpose (rows x k) and ("x", rest, B) with B the band (k x 8), A and
    B rebuilt lane by lane from the fragment words."""
    bf16 = dtype == "bfloat16"
    rows = tplan.TC_MMA_ROWS[dtype]
    t = emit.tc_table(ops, dtype, walk=True)[3].numpy()
    head = -(-(ops.n_s + 1) // 4) * 4
    lanes = np.arange(32)
    g, tig = lanes // 4, lanes % 4
    out = []
    for op in range(ops.n_s):
        groups = []
        for e in range(t[op], t[op + 1]):
            axis, rz, ry, rx, single, j, off, _ = t[head + 8 * e:
                                                    head + 8 * e + 8]
            rest = (rz, ry, rx)
            if single:
                c = t[off:off + 2].view(np.float64)[0]
                d = [rz, ry, rx]
                d[axis] = j
                groups.append(("lone", tuple(d), c))
                continue
            r = radii3[axis]
            if axis == 0:
                coef = t[off:off + 2 * (2 * r + 1)].view(np.float64)
                groups.append(("z", rest, coef))
                continue
            name = "y" if axis == 1 else "x"
            nk = tplan.tc_band_ksteps(r, dtype, name)
            words = tplan.tc_fragment_words(r, dtype, name)
            frag = t[off:off + words].view(np.uint32)
            if not bf16:  # one double a lane a k-step: B[4s+t][g], A[g][4s+t]
                f = frag.view(np.float64).reshape(nk, 32)
                m = np.zeros((4 * nk, 8))
                for s in range(nk):
                    m[4 * s + tig, g] = f[s]
                groups.append((name, rest, m if name == "x" else m.T))
                continue
            if name == "x":  # B: {B[k][g], B[k+1][g]}, {B[k+8][g], ..}
                f = frag.reshape(nk, 32, 2)
                m = np.zeros((16 * nk, 8))
                for s in range(nk):
                    k = 16 * s + 2 * tig
                    for w, dk in ((0, 0), (1, 8)):
                        lo, hi = _bf16_halves(f[s, :, w])
                        m[k + dk, g], m[k + dk + 1, g] = lo, hi
                groups.append(("x", rest, m))
            else:  # A: {A[g][k], ..}, {A[g+8][k], ..}, {A[g][k+8], ..}, ..
                f = frag.reshape(nk, 32, 4)
                m = np.zeros((rows, 16 * nk))
                for s in range(nk):
                    k = 16 * s + 2 * tig
                    for w, dm, dk in ((0, 0, 0), (1, 8, 0), (2, 0, 8),
                                      (3, 8, 8)):
                        lo, hi = _bf16_halves(f[s, :, w])
                        m[g + dm, k + dk], m[g + dm, k + dk + 1] = lo, hi
                groups.append(("y", rest, m))
        out.append(groups)
    return out


def _replay(plan, ops, fp, phis, aux=None):
    """The tc walk on ``fp`` ((B,) n_f, *padded), replayed in numpy in
    float64 with the plan's layout; ``phis`` one φ per sweep (select or
    MHD), ``aux`` the substep pair's w (padded by r). Returns the
    outputs, checking every ring read and every store on the way."""
    lift = tplan._stream3
    padded = tuple(n + 2 * h for n, h in zip(plan.interior, plan.halo))
    (_, _, _), (rz, ry, rx) = lift(plan.block, 1), lift(plan.radii, 0)
    pz, py, px = lift(padded, 1)
    nz, ny, nx = lift(plan.interior, 1)
    rows = tplan.TC_MMA_ROWS[plan.dtype]
    ring = plan.walk_ring
    inp = ring.inp
    wyi, wxi = inp.window
    v = 16 // tplan.ITEMSIZE[plan.dtype]
    depth, nf = plan.fuse_steps, plan.n_f
    q_, p_, c_ = ring.mid_slots, inp.period, ring.carry_slots
    groups = _groups(ops, plan.dtype, (rz, ry, rx))
    slots = [ops.names.index(n) for n in phis[0].operators]
    n_out = phis[0].n_out(nf)
    n_aux = n_out - nf
    fp = np.asarray(fp, np.float64).reshape(plan.batch, nf, pz, py, px)
    flat = np.concatenate([fp.reshape(-1), np.zeros(v)])
    pfield, psz = pz * py * px, py * px
    out = np.full((plan.batch, n_out, nz, ny, nx), np.nan)
    schedule = tplan.walk_schedule(plan)
    columns = tplan.persistent_walk(plan, 1)[0]
    assert len(columns) == len(set(columns)) == plan.walk_items
    ks = np.arange(nf)[:, None, None]
    n8 = np.arange(8)
    for member, z0, y0, x0 in columns:
        base = member * nf * pfield + z0 * psz + y0 * px + x0
        s0 = base % v
        buf = np.full(nf * inp.field_stride + v, np.nan)
        held = {}
        mids = [np.full(nf * q_ * y * x, np.nan)
                for y, x in ring.regions[:-1]]
        mid_held = [{} for _ in mids]
        carry = [np.full(max(n_aux, 1) * c_ * y * x, np.nan)
                 for y, x in ring.regions[1:]]
        for ev in schedule:
            if ev[0] == "fetch":
                for j, slot_ in ev[2]:
                    held[slot_] = (j, ev[1])
                    for k in range(nf):
                        for y in range(wyi):
                            g0 = base + k * pfield + j * psz + y * px
                            a = g0 % v
                            b = (k * inp.field_stride + s0 + slot_ * inp.plane
                                 + y * inp.pitch)
                            assert b % v == a
                            for q in range(-(-(wxi + a) // v)):
                                buf[b - a + q * v:b - a + (q + 1) * v] = (
                                    flat[g0 - a + q * v:g0 - a + (q + 1) * v])
                continue
            _, i, s, lo, hi = ev
            wy, wx = ring.regions[s]
            swy, swx = wy + 2 * ry, wx + 2 * rx
            if s == 0:
                src, per, at0 = buf, p_, s0
                sp, ss, sf = inp.pitch, inp.plane, inp.field_stride
            else:
                src, per, at0 = mids[s - 1], q_, 0
                sp, ss = swx, swy * swx
                sf = q_ * ss
            lines, ppp = tplan.tc_walk_patches(plan, s)
            segx = -(-wx // 8)

            def get(slot, row, col, ok):
                idx = at0 + ks * sf + slot * ss + row * sp + col
                return np.where(ok, src[np.where(ok, idx, 0)], 0.0)

            for z in range(lo, hi):
                c = (z + rz) % per
                for dz in range(-rz, rz + 1):  # landed, not overwritten
                    if s == 0:
                        assert held[(c + dz) % per][0] == z + rz + dz
                        assert held[(c + dz) % per][1] <= i
                    else:
                        assert mid_held[s - 1][(c + dz) % per] == z + rz + dz
                derivs = {}
                for op in set(slots):
                    res = np.full((nf, wy, wx), np.nan)
                    for p in range(ppp):
                        m = np.arange(rows)
                        if lines:
                            ys, xs = (p * rows + m) // segx, (
                                (p * rows + m) % segx) * 8
                            yp0 = xp0 = None
                        else:
                            yp0, xp0 = (p // segx) * rows, (p % segx) * 8
                            ys, xs = yp0 + m, np.full(rows, xp0)
                        outs = (ys[:, None] < wy) & (xs[:, None] + n8 < wx)
                        acc = np.zeros((nf, rows, 8))
                        for kind, rest, data in groups[op]:
                            if kind == "lone":
                                dz, dy, dx = rest
                                acc += data * get(
                                    (c + dz) % per, ys[:, None] + ry + dy,
                                    xs[:, None] + n8 + rx + dx, outs)
                            elif kind == "z":
                                for jj, cz in enumerate(data):
                                    if cz:
                                        acc += cz * get(
                                            (c - rz + jj) % per,
                                            ys[:, None] + ry,
                                            xs[:, None] + n8 + rx, outs)
                            elif kind == "y":
                                assert not lines
                                kk = np.arange(data.shape[1])[:, None]
                                row, col = yp0 + kk, xp0 + n8 + rx
                                win = get((c + rest[0]) % per, row, col,
                                          (row < swy) & (col < swx))
                                acc += data @ win
                            else:
                                kk = np.arange(data.shape[0])
                                row = ys[:, None] + ry + rest[1]
                                col = xs[:, None] + kk
                                win = get((c + rest[0]) % per, row, col,
                                          (ys[:, None] < wy) & (col < swx))
                                acc += win @ data
                        mm, nn = np.nonzero(outs)
                        yy, xx = ys[mm], xs[mm] + nn
                        assert np.isnan(res[:, yy, xx]).all()  # once each
                        res[:, yy, xx] = acc[:, mm, nn]
                    assert not np.isnan(res).any()
                    derivs[op] = res
                if len(slots) == 1:
                    rows_out = derivs[slots[0]]
                else:
                    d = {n: torch.from_numpy(derivs[op][:, None])
                         for n, op in zip(phis[s].operators, slots)}
                    if n_aux:
                        if s == 0:
                            w = aux[:, z0 + z, y0:y0 + wy, x0:x0 + wx]
                        else:
                            py_, px_ = ring.regions[s]
                            cz = (z + rz) % c_
                            w = carry[s - 1].reshape(n_aux, c_, py_, px_)[
                                :, cz]
                        rows_out = phis[s].torch_fn(
                            d, torch.from_numpy(np.array(w)[:, None]))
                    else:
                        rows_out = phis[s].torch_fn(d)
                    rows_out = rows_out.numpy()[:, 0]
                if s == depth - 1:
                    out[member, :, z0 + z, y0:y0 + wy, x0:x0 + wx] = rows_out
                else:
                    mids[s].reshape(nf, q_, wy, wx)[:, z % q_] = rows_out[:nf]
                    mid_held[s][z % q_] = z
                    if n_aux:
                        y1, x1 = ring.regions[s + 1]
                        carry[s].reshape(n_aux, c_, y1, x1)[:, z % c_] = (
                            rows_out[nf:, ry:ry + y1, rx:rx + x1])
    shape = ((plan.batch,) if plan.batch > 1 else ()) + (n_out,) + (
        plan.interior)
    assert not np.isnan(out).any()
    return out.reshape(shape)


def _fields(padded, dtype, seed=7):
    """Standard normal draws rounded to ``dtype`` (float64 values)."""
    f = torch.from_numpy(np.random.default_rng(seed).standard_normal(padded))
    return f.to(getattr(torch, dtype)).double().numpy()


# --- the replay -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape,order,depth,kw", (
    ((12, 37), 4, 2, dict(block=(3, 37))),             # rank 2: line patches
    ((24, 40), 6, 3, dict(block=(2, 20), segments=2, batch=3)),
    ((6, 12, 20), 4, 2, dict(block=(2, 6, 20))),        # rank 3: ragged patches
    ((12, 8, 16), 6, 3, dict(block=(2, 8, 8), segments=2, n_f=2)),
    ((8, 10, 12), 2, 2, dict(block=(4, 10, 12), batch=3)),
))
def test_replay_equals_the_plain_version(shape, order, depth, kw, dtype):
    """The kernel's staging, rings, patches and contractions replayed in
    numpy over every column (segments, three members, two fields, rank 2
    on line patches, ragged patches at rank 3): every ring read finds its
    planes, every output is stored once, and the outputs are the plain
    version's (the band rounded to f32: 1e-6 of float64's) and the tc
    plain version's."""
    ops, plan, padded = _plan(shape, order, depth, dtype=dtype, **kw)
    assert audit_plan(plan, ops).findings == []  # the static auditor too
    fp = _fields(padded, dtype)
    name = "dxx" if plan.n_f > 1 else ops.names[0]
    phi = select_phi(name)
    got = _replay(plan, ops, fp, (phi,) * depth)
    steps = (ref.fused_stencil_steps_batched if plan.batch > 1
             else ref.fused_stencil_steps)
    if dtype == "float32":
        exact = steps(torch.from_numpy(fp), ops, phi.torch_fn, depth)
        assert _rel(got, exact.numpy()) <= 1e-6
    tc = steps(torch.from_numpy(fp).to(getattr(torch, dtype)), ops,
               phi.torch_fn, depth, tc=True)
    assert _rel(got, tc.float().numpy()) <= TOL[dtype]


def test_replay_of_the_mhd_pair_feeds_its_carry():
    """The f32 MHD pair (substeps 1 and 2, aux w) on (1, 8, 8): patches of
    sweep 0's 14 x 14 region and sweep 1's 8 x 8, the w' carry ring cut to
    sweep 1's region, one step of planes in the input ring: the plain
    version's outputs, f' and w'."""
    shape = (6, 8, 16)
    solver, ops, plan = _pair_plan(shape)
    assert plan.block == (1, 8, 8) and plan.stage_buffers == 1
    f = solver.init_smooth(3, amplitude=1e-2, dtype=torch.float64)
    fp = pad(f, 6, "periodic", spatial_axes=(1, 2, 3)).numpy()
    w = 1e-3 * np.random.default_rng(4).random((8,) + shape)
    aux = pad(torch.from_numpy(w), 3, "periodic",
              spatial_axes=(1, 2, 3)).numpy()
    phis = tuple(tm.mhd_substep_device_phi(solver.params, tm.RK3_ALPHA[i],
                                           tm.RK3_BETA[i], 1e-3)
                 for i in (1, 2))
    got = _replay(plan, ops, fp, phis, aux=aux)
    want = ref.fused_stencil_steps(torch.from_numpy(fp), ops,
                                   [p.torch_fn for p in phis], 2,
                                   aux=torch.from_numpy(aux))
    assert got.shape == (16,) + shape
    assert _rel(got, want.numpy()) <= 1e-6


# --- the layout -------------------------------------------------------------------


def test_tc_walk_smem_bytes_counted_by_hand():
    """512³ f32 order 6 at depth 2 on (4, 32, 32): swc's walk rings (the
    input ring of 14 slots of the (44, 44) window in rows of 48, 524 mod 4
    = 0, planes of 2112; sweep 0's ring of 10 slots of (38, 38)), 16 bytes
    of divisors per sweep, then the depth-1 table: 2 starts (4 words), 3
    group rows, the z arm's 7 doubles (16 words), the y and x groups' 4
    f64 k-steps of 32 lanes. The f32 MHD pair on (1, 8, 8): 8 fields in 7
    slots of (20, 20) in rows of 24, sweep 0's 8 fields in 7 slots of (14, 14), w' in 4
    of (8, 8), the MHD table, φ's 10 x 8 f32 inputs for 2 patches."""
    _, plan, _ = _plan((512,) * 3, 6, 2)
    assert plan.block == (4, 32, 32) and plan.threads == 512
    assert plan.stage_buffers == 2 and plan.segments == 4
    ring = plan.walk_ring
    assert (ring.inp.window, ring.inp.pitch, ring.inp.plane,
            ring.inp.period) == ((44, 44), 48, 2112, 14)
    elements = 4 * -(-(3 + 13 * 2112 + 43 * 48 + 44) // 4)
    assert ring.inp.field_stride == elements
    table = 4 + 24 + 16 + 2 * 4 * 32 * 2
    assert plan.tc_table_words == table
    assert plan.smem_bytes == (4 * elements + 10 * 38 * 38 * 4 + 2 * 16
                               + 4 * table) == 178_288
    _, ops, pair = _pair_plan((256,) * 3)
    ring = pair.walk_ring
    assert pair.block == (1, 8, 8) and pair.stage_buffers == 1
    assert (ring.inp.window, ring.inp.pitch, ring.inp.plane,
            ring.inp.period) == ((20, 20), 24, 480, 7)
    elements = 4 * -(-(3 + 6 * 480 + 19 * 24 + 20) // 4)
    words = 12 + 27 * 8 + 3 * 4 + 2 * 16 + 22 * 4 * 32 * 2
    assert pair.tc_table_words == words == tplan.tc_table_words(ops,
                                                                "float32")
    rings = 8 * elements * 4 + 8 * 7 * 14 * 14 * 4 + 8 * 4 * 8 * 8 * 4
    assert pair.smem_bytes == (rings + 2 * 16 + 4 * words
                               + 4 * 10 * 8 * 2 * 64) == 224_224
    # Rank 2 lifted: the table's Y groups are z arms (2r + 1 doubles), not
    # y fragments, and the layout follows.
    _, two, _ = _plan((64, 400), 6, 2)
    assert two.tc_table_words == tplan.tc_table_words(
        two_ops := td.DiffusionProblem((64, 400)).step_op(
            "hwc", device=CPU).ops, "float32", walk=True)
    assert two.tc_table_words == 4 + 16 + 16 + 4 * 32 * 2
    assert two.tc_table_words != tplan.tc_table_words(two_ops, "float32")


def test_tc_walk_patches_and_issued_macs():
    """Sweep 0 of 512³ S=2 on (4, 32, 32) holds 38 x 38 points in 5 x 5
    patches of 8 x 8, sweep 1 32 x 32 in 4 x 4; rank 2 lifted cuts a
    262-point row into 33 segments, 5 patches of 8 lines (3 of 16 in
    bf16). The issued multiply-adds: per patch 8 x 8 x (16 + 16) on the
    MMA (k = 4 ceil(14 / 4)) and 6 z taps x 64 FMAs, over every plane a
    segment computes, 4 patches a warp's batch."""
    ops, plan, _ = _plan((512,) * 3, 6, 2)
    assert [tplan.tc_walk_patches(plan, s) for s in (0, 1)] == [
        (False, 25), (False, 16)]
    issued, needed = tplan.tc_issued_macs(plan, ops, ["step"])
    per_patch = 64 * (16 + 16 + 6)
    seg = 512 // plan.segments
    patches = (seg + 6) * 28 + seg * 16  # 25 -> 28: batches of 4
    assert issued == per_patch * patches * plan.walk_items
    assert needed == 19 * ((seg + 6) * 38 * 38 + seg * 32 * 32) * (
        plan.walk_items)
    _, two, _ = _plan((512, 1024), 6, 2, block=(4, 256))
    assert tplan.tc_walk_patches(two, 0) == (True, 5)
    _, bf, _ = _plan((512, 1024), 6, 2, block=(4, 256), dtype="bfloat16")
    assert tplan.tc_walk_patches(bf, 0) == (True, 3)


# --- the planner's rules -----------------------------------------------------------


def test_tc_walk_plan_rules():
    """tc at depth > 1 walks for select in f32 and bf16 at ranks 2-3 and
    the f32 MHD kinds at rank 3 (persistent, 512 threads, the depth-1
    table's words in the geometry select the walk); rank 1 keeps the
    one-tile body with TcEval; f64 raises the tc dtype rule; swc_stream at
    depth > 1 walks for select in f32 and f64 under its own kernel name,
    the f64 MHD RHS at depth 1 keeps the one-buffer body."""
    for shape, dtype in (((64, 128), "float32"), ((16, 32, 64), "bfloat16")):
        ops, plan, _ = _plan(shape, 6, 2, dtype=dtype)
        g = emit.geometry(plan, [0])
        assert g[emit.GEOM_LEN - 2] == plan.tc_table_words > 0
        assert g[-1] == 0 and plan.threads == tplan.TC_WALK_THREADS
        assert emit.kernel_name(plan) == emit.TC_KERNEL
        assert plan.stage_buffers == tplan.WALK_STAGES["select"]
    assert emit.geometry(_plan((64, 128), 6, 3)[1], [0])[3:6].tolist() == [
        64, 1, 128]  # rank 2 lifted to (Y, 1, X)
    d1 = td.DiffusionProblem((4096,)).step_op("hwc", device=CPU).ops
    one = tplan.plan_stencil(d1, (1, 4108), 1, strategy="tc", fuse_steps=2)
    assert not one.tc_walk and not one.persistent
    assert emit.geometry(one, [0])[emit.GEOM_LEN - 2] == 0
    _, ops, pair = _pair_plan((16, 16, 32))
    assert (pair.threads, pair.stage_buffers, pair.block) == (
        512, 1, tplan.DEFAULT_TC_WALK_MHD_BLOCK)
    rhs2 = plan_for_nd(ops, (8, 28, 28, 44), 8, strategy="tc", fuse_steps=2,
                       max_threads=256, n_slots=10)
    assert rhs2.tc_walk and rhs2.block == (1, 8, 8)
    for kind in ("select", "mhd"):
        assert tplan.walk_kind(3, 1 if kind == "select" else 10, 0,
                               "float64", "tc") is False
    diff = td.DiffusionProblem((64, 64, 64)).step_op("hwc", device=CPU).ops
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        tplan.plan_stencil(diff, (1, 28, 28, 44), 1, strategy="tc",
                           fuse_steps=2, dtype="float64")
    for dtype, threads in (("float32", 512), ("float64", 256)):
        st = tplan.plan_stencil(diff, (1, 76, 76, 76), 1,
                                strategy="swc_stream", fuse_steps=2,
                                dtype=dtype)
        assert st.stream_walk and st.walk and not st.temporal_walk
        assert (st.threads, st.outputs_per_thread) == (threads, 4)
        assert emit.kernel_name(st) == emit.STREAM_KERNEL
        assert emit.geometry(st, [0])[-1] == 4
        swc = dataclasses.replace(st, strategy="swc")
        assert swc.temporal_walk and swc.smem_bytes == st.smem_bytes
    assert not tplan.walk_kind(3, 10, 0, "float32", "swc_stream")
    with pytest.raises(ValueError, match="rank 2"):
        tplan.plan_stencil(td.DiffusionProblem((64,)).step_op(
            "hwc", device=CPU).ops, (1, 76), 1, strategy="swc_stream",
            fuse_steps=2)


@pytest.mark.parametrize("strategy,shape,dtype,n_slots,err,match", (
    ("tc", (64, 128), "float32", 2, ValueError, "walk only"),
    ("tc", (4096,), "float32", 2, ValueError, "walk only"),
    ("tc", (64, 128), "bfloat16", 2, ValueError, "walk only"),
    ("swc_stream", (48, 64, 80), "float32", 10, ValueError,
     "use strategy='swc'"),
    ("swc_stream", (48, 64, 80), "float64", 10, ValueError,
     "use strategy='swc'"),
))
def test_mhd_plans_that_do_not_walk_are_refused(strategy, shape, dtype,
                                                n_slots, err, match):
    """At depth > 1 ``tc`` runs the MHD kinds on its walk only (rank 3,
    float32 or bfloat16) and ``swc_stream`` the select kind only: an MHD
    plan (several operator slots) that would take the one-tile or the
    one-buffer body raises instead, before any tile is fitted (the f32
    MHD RHS twice at (48, 64, 80) once fitted a 20-point tile of the
    one-buffer body)."""
    if n_slots == 10:
        ops = ts.derivative_operator_set(3, 6)
        padded = (8,) + tuple(n + 12 for n in shape)
        n_f = 8
    else:
        ops = td.DiffusionProblem(shape).step_op("hwc", device=CPU).ops
        padded = (1,) + tuple(n + 2 * r * 2 for n, r in
                              zip(shape, ops.radius_per_axis()))
        n_f = 1
    with pytest.raises(err, match=match):
        tplan.plan_stencil(ops, padded, n_f, strategy=strategy, dtype=dtype,
                           fuse_steps=2, max_threads=256, n_slots=n_slots)


def test_tc_walk_tiles_and_fit():
    """The planner's tiles (f32 and bf16 at depth 2 and 3, rank 2, the MHD
    pair's (1, 8, 8), which MHDSolver leaves to it), segments that give
    MIN_WALK_ITEMS columns, and a tile over what fits narrowed."""
    for dtype in ("float32", "bfloat16"):
        for depth in (2, 3):
            _, p, _ = _plan((256,) * 3, 6, depth, dtype=dtype)
            assert p.block == tplan.DEFAULT_WALK_BLOCKS3["float32", depth]
            assert p.smem_bytes <= tplan.SMEM_PER_BLOCK
    _, two, _ = _plan((512, 1024), 6, 2)
    assert two.block == tplan.DEFAULT_WALK_BLOCK2
    _, f32, _ = _plan((512,) * 3, 6, 2)
    assert f32.walk_items >= tplan.MIN_WALK_ITEMS and f32.segments == 4
    solver = tm.MHDSolver((32, 32, 64), strategy="tc", fuse_rk_pairs=True,
                          device=CPU)
    assert solver._fused_pair_op(1e-3).block is None
    _, _, pair = _pair_plan((32, 32, 64))
    assert pair.block == (1, 8, 8)
    _, _, wide = _pair_plan((32, 32, 64), block=(1, 8, 32))
    assert wide.block[2] < 32 and wide.smem_bytes <= tplan.SMEM_PER_BLOCK


# --- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", ((96, 120), (24, 40, 56)))
@pytest.mark.parametrize("depth", (2, 3))
def test_tc_walk_matches_plain_on_card(cuda_device, shape, depth, dtype):
    ops, plan, padded = _plan(shape, 6, depth, dtype=dtype)
    assert emit.kernel_smem_bytes(plan) == plan.smem_bytes
    fp = torch.from_numpy(_fields(padded, dtype)).to(
        cuda_device, getattr(torch, dtype))
    phi = select_phi(ops.names[0])
    emit.reset_launch_counts()
    got = emit.fused_stencil_swc(fp, ops, phi, plan)
    assert emit.fused_stencil_swc.launches_by_kernel == {emit.TC_KERNEL: 1}
    want = ref.fused_stencil_tc_steps(fp, ops, phi.torch_fn, depth)
    assert _rel(got.float().cpu(), want.float().cpu()) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("segments", (1, 4))
def test_tc_walk_segments_and_members_on_card(cuda_device, segments):
    """Segments forced to 1 and 4, three members of two fields: the
    batched launch equals the plain version, and each member its
    unbatched launch exactly."""
    ops, plan, padded = _plan((64, 24, 40), 6, 2, batch=3, n_f=2,
                              segments=segments)
    fp = torch.from_numpy(_fields(padded, "float32")).to(
        cuda_device, torch.float32)
    phi = select_phi("dxx")
    got = emit.fused_stencil_swc(fp, ops, phi, plan)
    want = ref.fused_stencil_tc_steps(fp[0], ops, phi.torch_fn, 2)
    assert _rel(got[0].cpu(), want.cpu()) <= TOL["float32"]
    solo = dataclasses.replace(plan, batch=1)
    for m in range(3):
        assert torch.equal(got[m], emit.fused_stencil_swc(fp[m], ops, phi,
                                                          solo))


@pytest.mark.cuda
@pytest.mark.parametrize("substep", (False, True))
def test_tc_walk_mhd_matches_plain_on_card(cuda_device, substep):
    """The MHD RHS twice and the substep pair (aux w) on the tc walk."""
    shape = (16, 24, 32)
    solver = tm.MHDSolver(shape, strategy="tc", device=cuda_device)
    f = solver.init_smooth(0, amplitude=1e-2, dtype=torch.float32)
    fp = pad(f, 6, "periodic", spatial_axes=(1, 2, 3))
    if substep:
        phis = tuple(tm.mhd_substep_device_phi(
            solver.params, tm.RK3_ALPHA[i], tm.RK3_BETA[i], 1e-3)
            for i in (1, 2))
        w = 1e-3 * torch.rand((8,) + shape, generator=torch.Generator()
                              .manual_seed(1), dtype=torch.float64)
        aux = pad(w.to(cuda_device, torch.float32), 3, "periodic",
                  spatial_axes=(1, 2, 3))
    else:
        phis, aux = (tm.mhd_rhs_device_phi(solver.params),) * 2, None
    n_out = phis[0].n_out(8)
    plan = plan_for_nd(solver.operator_set, tuple(fp.shape), n_out,
                       aux_shape=None if aux is None else tuple(aux.shape),
                       strategy="tc", fuse_steps=2, max_threads=256,
                       n_slots=10)
    assert plan.tc_walk and emit.kernel_smem_bytes(plan) == plan.smem_bytes
    got = emit.fused_stencil_swc(fp, solver.operator_set, phis, plan,
                                 aux=aux)
    want = ref.fused_stencil_tc_steps(fp, solver.operator_set,
                                      [p.torch_fn for p in phis], 2, aux=aux)
    assert _rel(got.cpu(), want.cpu()) <= TOL["float32"]
