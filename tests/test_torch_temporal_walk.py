"""The temporal kernel's walk body (B2 at depth > 1, select kind, ranks 2
and 3: ``csrc/temporal_walk_body.cuh``; the stream kernel runs the same
body at depth > 1, B3's walk): its host side on the CPU — the
walk of the columns, the fetch and sweep schedule, the rings, the tap rows
per ring slot, the staging into rows congruent to the padded field's
modulo 16 bytes, the shared-memory layout, the planner's rules — and, on
the card, the kernel against its plain version.

The replay mirrors the kernel in numpy: plane j of a column segment's
window goes to input slot j mod P; a window row (j, y) of field k
starting ``a`` elements into its first 16 bytes goes to ring element
``b = k fstride + s0 + slot plane + y pitch`` (``b = a`` mod V), chunk q
from ``q V - a`` of the row to ``b - a + q V``; sweep s's plane z reads its
source ring's slot c = (z + rz) mod period through tap row c and writes
ring s's slot z mod (tau + 2rz), the last sweep the output. Replaying
``plan.walk_schedule`` over every column, each ring must hold exactly the
planes a sweep reads when it reads them, and the outputs must be the plain
version's (float64, 1e-12). Tolerances on the card: f32 1e-5 and f64
1e-12 relative to the largest |value|; a member of a batched launch
equals its unbatched launch exactly. The port against the JAX package at
depth > 1 is ``test_torch_temporal.py``'s.
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
from repro_torch.kernels.ops import fused_stencil_nd, plan_for_nd
from repro_torch.kernels.phi import select_phi
from repro_torch.physics import mhd as tmhd
from repro_torch.physics.diffusion import DiffusionProblem

TOL = {"float32": 1e-5, "float64": 1e-12}
CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _plan(shape, order, depth, *, n_f=1, batch=None, dtype="float32",
          block=None, segments=None, strategy="swc"):
    """A walk plan (``swc``, or ``swc_stream``) for diffusion's operator
    (order ``order``) or, with ``n_f`` > 1, the derivative set's
    ``dxx``."""
    if n_f == 1:
        ops = DiffusionProblem(shape, accuracy=order).step_op(
            "swc", device=CPU).ops
    else:
        ops = ts.derivative_operator_set(len(shape), order, 0.3)
    r = ops.radius_per_axis()
    lead = (n_f,) if batch is None else (batch, n_f)
    padded = lead + tuple(n + 2 * q * depth for n, q in zip(shape, r))
    plan = tplan.plan_stencil(ops, padded, n_f, block=block, dtype=dtype,
                              fuse_steps=depth, strategy=strategy)
    if segments is not None:
        plan = dataclasses.replace(plan, segments=segments)
    assert plan.walk and plan.temporal_walk == (strategy == "swc")
    assert plan.stream_walk == (strategy == "swc_stream")
    return ops, plan, padded


def _lifted(plan):
    """(step and cross tile, radii, padded, interior) as the walk sees
    them: rank 2 lifted to (Y, 1, X)."""
    padded = tuple(n + 2 * h for n, h in zip(plan.interior, plan.halo))
    return (tplan._stream3(plan.block, 1), tplan._stream3(plan.radii, 0),
            tplan._stream3(padded, 1), tplan._stream3(plan.interior, 1))


def _tap_rows(plan, offsets):
    """The kernel's tap rows: one per slot of the input ring, then of each
    intermediate ring, tap (dz, dy, dx) at ((c + dz) mod period - c) plane
    + dy pitch + dx (at rank 2 the y offset runs along the walk)."""
    ring = plan.walk_ring
    ry = _lifted(plan)[1][1]
    rings = [(ring.inp.period, ring.inp.plane, ring.inp.pitch)] + [
        (ring.mid_slots, y * x, x) for y, x in ring.regions[:-1]]
    rows = []
    for per, plane, pitch in rings:
        for c in range(per):
            row = []
            for dz, dy, dx in offsets:
                if ry == 0:
                    dz, dy = dz + dy, 0
                row.append(((c + dz) % per - c) * plane + dy * pitch + dx)
            rows.append(row)
    return np.asarray(rows)


def _replay(plan, ops, fp, slot=0):
    """The walk body on ``fp`` ((B,) n_f, *padded), replayed in numpy in
    float64 with the plan's layout (its dtype's 16-byte vectors): returns
    the outputs, checking every ring read on the way."""
    (tz, ty, tx), (rz, ry, rx), (pz, py, px), (nz, ny, nx) = _lifted(plan)
    ring = plan.walk_ring
    inp = ring.inp
    wy, wx = inp.window
    v = 16 // tplan.ITEMSIZE[plan.dtype]
    depth, nf, q_, p_ = (plan.fuse_steps, plan.n_f, ring.mid_slots,
                         inp.period)
    offsets, coeffs, starts = emit.tap_table(ops)
    rows = _tap_rows(plan, offsets.tolist())
    coeffs = coeffs.numpy()
    b0, e0 = int(starts[slot]), int(starts[slot + 1])
    fp = np.asarray(fp, np.float64).reshape(plan.batch, nf, pz, py, px)
    flat = np.concatenate([fp.reshape(-1), np.zeros(v)])
    pfield, psz = pz * py * px, py * px
    seg = nz // plan.segments
    out = np.full((plan.batch, nf, nz, ny, nx), np.nan)
    schedule = tplan.walk_schedule(plan)
    columns = tplan.persistent_walk(plan, 1)[0]
    assert len(columns) == len(set(columns)) == plan.walk_items
    for member, z0, y0, x0 in columns:
        base = member * nf * pfield + z0 * psz + y0 * px + x0
        s0 = base % v
        buf = np.full(nf * inp.field_stride + v, np.nan)
        held = {}  # input slot: (plane, step that fetched it)
        mids = [np.full(nf * q_ * y * x, np.nan) for y, x in
                ring.regions[:-1]]
        mid_held = [{} for _ in mids]
        for ev in schedule:
            if ev[0] == "fetch":
                for j, slot_ in ev[2]:
                    held[slot_] = (j, ev[1])
                    for k in range(nf):
                        for y in range(wy):
                            g0 = base + k * pfield + j * psz + y * px
                            a = g0 % v
                            b = (k * inp.field_stride + s0 + slot_ * inp.plane
                                 + y * inp.pitch)
                            assert b % v == a and (b - a) % v == 0
                            for q in range(-(-(wx + a) // v)):
                                buf[b - a + q * v:b - a + (q + 1) * v] = (
                                    flat[g0 - a + q * v:g0 - a + (q + 1) * v])
                continue
            _, i, s, lo, hi = ev
            ry_s, rx_s = ring.regions[s]
            yy, xx = np.meshgrid(np.arange(ry_s), np.arange(rx_s),
                                 indexing="ij")
            for z in range(lo, hi):
                if s == 0:
                    per, src, row0 = p_, buf, 0
                    sp, ss, sf = inp.pitch, inp.plane, inp.field_stride
                    at0 = s0
                    for dz in range(2 * rz + 1):  # landed, not overwritten
                        assert held[(z + dz) % per][0] == z + dz
                        assert held[(z + dz) % per][1] <= i
                else:
                    py_, px_ = ring.regions[s - 1]
                    per, src, row0 = q_, mids[s - 1], p_ + (s - 1) * q_
                    sp, ss, sf, at0 = px_, py_ * px_, q_ * py_ * px_, 0
                    for dz in range(2 * rz + 1):
                        assert mid_held[s - 1][(z + dz) % per] == z + dz
                c = (z + rz) % per
                for k in range(nf):
                    cen = at0 + k * sf + c * ss + (yy + ry) * sp + xx + rx
                    acc = np.zeros(cen.shape)
                    for t in range(b0, e0):
                        acc = acc + coeffs[t] * src[cen + rows[row0 + c][t]]
                    if s == depth - 1:
                        out[member, k, z0 + z, y0:y0 + ry_s,
                            x0:x0 + rx_s] = acc
                    else:
                        plane = ry_s * rx_s
                        mids[s][k * q_ * plane + (z % q_) * plane
                                + yy * rx_s + xx] = acc
                if s < depth - 1:
                    mid_held[s][z % q_] = z
    shape = ((plan.batch,) if plan.batch > 1 else ()) + (nf,) + plan.interior
    return out.reshape(shape)


# --- the walk: columns, fetches, sweeps ---------------------------------------


@pytest.mark.parametrize("shape,order,depth,kw", (
    ((24, 40), 4, 2, dict(block=(2, 40))),                       # rank 2
    ((24, 40), 4, 3, dict(block=(4, 20), segments=2, batch=3)),
    ((16, 8, 32), 6, 2, dict(block=(1, 8, 32))),                 # rank 3
    ((24, 8, 16), 6, 3, dict(block=(2, 4, 16), segments=3, batch=3)),
    ((20, 6, 8), 2, 9, dict(block=(1, 6, 8))),                   # depth 9
))
@pytest.mark.parametrize("stages", (1, 2))
def test_walk_schedule_lands_every_plane_once_and_feeds_each_sweep(
        shape, order, depth, kw, stages, monkeypatch):
    """Over a column segment: every padded plane of its window is fetched
    once, each step's planes ``stages - 1`` steps ahead (the first with
    the 2rz leading ones; with one stage once sweep 0 has read the ring);
    sweep s computes each of its planes once, after
    the planes it reads (its source's z - rz .. z + rz) are in; the last
    sweep's planes are the segment's outputs. The columns of all blocks
    cover members x segments x cross tiles once."""
    monkeypatch.setitem(tplan.WALK_STAGES, "select", stages)
    ops, plan, _ = _plan(shape, order, depth, **kw)
    assert plan.stage_buffers == stages
    assert audit_plan(plan, ops).findings == []  # the static auditor too
    ring = plan.walk_ring
    tau, lead = plan.block[0], ring.inp.lead
    seg = plan.interior[0] // plan.segments
    assert ring.inp.period >= stages * tau + lead
    assert ring.mid_slots == tau + lead
    events = tplan.walk_schedule(plan)
    fetched = [j for ev in events if ev[0] == "fetch" for j, _ in ev[2]]
    assert sorted(fetched) == list(range(seg + lead * depth))
    done = [set() for _ in range(depth)]
    landed = set()
    for ev in events:
        if ev[0] == "fetch":
            landed.update(j for j, _ in ev[2])
            continue
        _, i, s, lo, hi = ev
        for z in range(lo, hi):
            assert z not in done[s]
            need = range(z, z + lead + 1)
            assert all((j in landed) if s == 0 else (j in done[s - 1])
                       for j in need)
            done[s].add(z)
    for s in range(depth):
        assert done[s] == set(range(seg + lead * (depth - 1 - s)))
    for grid in (1, 5):
        walks = tplan.persistent_walk(plan, grid)
        cols = [c for w in walks for c in w]
        assert len(cols) == len(set(cols)) == plan.walk_items
        assert {c[0] for c in cols} == set(range(plan.batch))
        assert {c[1] for c in cols} == {s * seg for s in
                                        range(plan.segments)}


def test_runs_cover_each_plane_once():
    """Warp runs of 32 U points: lane l of run r takes r 32 U + l + 32 u,
    a point past the plane repeating the last one unstored; the stored
    points are the plane's, once each."""
    for pts in (1, 31, 128, 500, 836, 1000):
        for u in (tplan.WALK_OUTPUTS["select"],):
            runs = -(-pts // (32 * u))
            stored = [r * 32 * u + lane + 32 * k for r in range(runs)
                      for lane in range(32) for k in range(u)
                      if r * 32 * u + lane + 32 * k < pts]
            assert sorted(stored) == list(range(pts))


@pytest.mark.parametrize("block", ((1, 4, 16), (2, 4, 8)))
def test_mhd_walk_schedule_feeds_the_carry(block):
    """The f32 MHD pair on the walk: one step of planes in the input ring,
    the next fetched once sweep 0 has read it, and the carry ring of tau +
    rz slots holding sweep 0's w' at the plane sweep 1 reads it at (its
    plane z + rz) when it reads it."""
    ops = ts.derivative_operator_set(3, 6)
    plan = plan_for_nd(ops, (8, 40, 28, 28), 16, aux_shape=(8, 34, 22, 22),
                       block=block, fuse_steps=2, max_threads=256,
                       n_slots=10)
    assert plan.temporal_walk and plan.block == block
    assert plan.stage_buffers == 1
    assert audit_plan(plan, ops).findings == []  # the static auditor too
    ring = plan.walk_ring
    assert ring.carry_slots == block[0] + 3
    assert ring.inp.period >= block[0] + ring.inp.lead
    carry, landed, done = {}, set(), set()
    for ev in tplan.walk_schedule(plan):
        if ev[0] == "fetch":
            assert all(j not in landed for j, _ in ev[2])
            landed.update(j for j, _ in ev[2])
            continue
        _, i, s, lo, hi = ev
        for z in range(lo, hi):
            if s == 0:
                assert all(j in landed for j in range(z, z + 7))
                carry[z % ring.carry_slots] = z
                done.add(z)
            else:
                assert all(j in done for j in range(z, z + 7))
                assert carry[(z + 3) % ring.carry_slots] == z + 3


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("shape,order,depth,kw", (
    ((12, 37), 4, 2, dict(block=(3, 37))),            # rank 2, ragged pitch
    ((24, 37), 4, 3, dict(block=(2, 37), segments=2, batch=2)),
    ((9, 6, 37), 4, 2, dict(block=(1, 3, 37))),       # rank 3, ragged pitch
    ((12, 4, 8), 6, 3, dict(block=(2, 2, 8), segments=2, n_f=2)),
    ((8, 4, 6), 2, 9, dict(block=(1, 4, 6))),
))
@pytest.mark.parametrize("stages", (1, 2))
def test_replay_equals_the_plain_version(shape, order, depth, kw, dtype,
                                         stages, monkeypatch):
    """The kernel's staging, rings, tap rows and sweeps replayed in numpy
    over every column: each ring read finds its planes, and the outputs
    are the plain version's (float64 arithmetic on the dtype's layout:
    its 16-byte vectors, pitches and slots)."""
    monkeypatch.setitem(tplan.WALK_STAGES, "select", stages)
    ops, plan, padded = _plan(shape, order, depth, dtype=dtype, **kw)
    rng = np.random.default_rng(7)
    fp = rng.standard_normal(padded)
    slot = 0
    name = ops.names[slot]
    if plan.n_f > 1:
        slot = ops.names.index("dxx")
        name = "dxx"
    got = _replay(plan, ops, fp, slot)
    step = (ref.fused_stencil_steps_batched if plan.batch > 1
            else ref.fused_stencil_steps)
    want = step(torch.from_numpy(fp), ops, lambda d: d[name], depth)
    assert _rel(got, want.numpy()) <= 1e-12


@pytest.mark.parametrize("strategy", ("swc", "swc_stream"))
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("shape,order,depth,kw", (
    ((24, 37), 4, 3, dict(block=(2, 37), segments=2, batch=2)),
    ((24, 4, 8), 6, 3, dict(block=(2, 2, 8), segments=2, n_f=2)),
    ((20, 6, 12), 2, 2, dict(block=(4, 3, 12), batch=3)),
))
def test_replay_of_both_strategies_equals_the_plain_version(
        shape, order, depth, kw, dtype, strategy):
    """``swc`` and ``swc_stream`` at depth > 1 walk the same columns with
    the same body: the same geometry (the stream kernel's chunk the walk's
    step, its cross tile and segments the walk's), the same layout, and
    the replay over every column gives the plain version's outputs."""
    ops, plan, padded = _plan(shape, order, depth, dtype=dtype,
                              strategy=strategy, **kw)
    other = dataclasses.replace(plan, strategy="swc" if strategy != "swc"
                                else "swc_stream")
    assert other.walk and other.smem_bytes == plan.smem_bytes
    assert emit.geometry(other, [0]).tolist() == emit.geometry(
        plan, [0]).tolist()
    assert other.walk_items == plan.walk_items
    fp = np.random.default_rng(3).standard_normal(padded)
    name = "dxx" if plan.n_f > 1 else ops.names[0]
    got = _replay(plan, ops, fp, ops.names.index(name))
    step = (ref.fused_stencil_steps_batched if plan.batch > 1
            else ref.fused_stencil_steps)
    want = step(torch.from_numpy(fp), ops, lambda d: d[name], depth)
    assert _rel(got, want.numpy()) <= 1e-12


# --- the layout ---------------------------------------------------------------


def test_walk_smem_bytes_counted_by_hand():
    """512³ f32 order 6 at depth 3 on (1, 16, 32): the input ring of 8
    plane slots of the (34, 50) window in rows of 54 (530 mod 4 = 2) and
    planes of 1836 elements; sweep 0's and 1's rings of 7 slots of (28,
    44) and (22, 38); 16 bytes of divisors per sweep; 8 + 2 x 7 tap rows
    of 19 taps of 8 bytes."""
    _, plan, _ = _plan((512,) * 3, 6, 3, block=(1, 16, 32))
    assert plan.block == (1, 16, 32) and plan.stage_buffers == 2
    ring = plan.walk_ring
    assert (ring.inp.pitch, ring.inp.plane, ring.inp.period) == (54, 1836, 8)
    elements = 4 * -(-(3 + 7 * 1836 + 33 * 54 + 50) // 4)
    assert ring.inp.field_stride == elements == 14688
    mids = [7 * 28 * 44 * 4, 7 * 22 * 38 * 4]
    taps = (8 + 2 * 7) * 19 * 8
    assert ring.mid_bytes == tuple(mids)
    assert plan.smem_bytes == 4 * elements + sum(mids) + 3 * 16 + taps
    assert plan.smem_bytes == 120_048
    # f64 256³ depth 2 on (1, 8, 32): rows of 46 (274 mod 2 = 0), one
    # intermediate ring, taps of 16 bytes.
    _, f64, _ = _plan((256,) * 3, 6, 2, dtype="float64", block=(1, 8, 32))
    assert f64.block == (1, 8, 32)
    ring = f64.walk_ring
    assert (ring.inp.window, ring.inp.pitch, ring.inp.period) == (
        (20, 44), 46, 8)
    elements = 2 * -(-(1 + 7 * 20 * 46 + 19 * 46 + 44) // 2)
    assert f64.smem_bytes == (8 * elements + 8 * 7 * 14 * 38 + 2 * 16
                              + (8 + 7) * 19 * 16)
    # The f32 MHD pair 256³ on (1, 4, 16): 8 fields in 7 input slots (one
    # step) of (16, 28) in rows of 32, sweep 0's 8 fields in 7 slots of
    # (10, 22), its w' cut to (4, 16) in 4 slots, 14 tap rows of 148 taps,
    # then φ's 10 x 8 inputs for 128 points.
    mhd = ts.derivative_operator_set(3, 6)
    pair = plan_for_nd(mhd, (8, 268, 268, 268), 16,
                       aux_shape=(8, 262, 262, 262), fuse_steps=2,
                       max_threads=256, n_slots=10)
    ring = pair.walk_ring
    assert pair.block == (1, 4, 16) and pair.stage_buffers == 1
    assert (ring.inp.window, ring.inp.pitch, ring.inp.plane,
            ring.inp.period) == ((16, 28), 32, 512, 7)
    elements = 4 * -(-(3 + 6 * 512 + 15 * 32 + 28) // 4)
    rings = (8 * elements + 8 * 7 * 10 * 22) * 4 + 8 * 4 * 4 * 16 * 4
    taps = (7 + 7) * 148 * 8
    assert ring.carry_bytes == (8 * 4 * 4 * 16 * 4,)
    assert pair.smem_bytes == rings + 2 * 16 + taps + 10 * 8 * 128 * 4
    assert pair.smem_bytes == 229_728
    # Rank 2 lifted: the walk along Y, rows of one window line.
    _, two, _ = _plan((64, 400), 6, 2)
    ring = two.walk_ring
    assert ring.inp.window == (1, two.block[1] + 12)
    assert ring.regions == ((1, two.block[1] + 6), (1, two.block[1]))


# --- the planner's rules --------------------------------------------------------


def test_walk_plan_rules():
    """The walk takes the select kind at ranks 2 and 3 in f32 and f64 at
    depth > 1: persistent (gridDim.z does not bind it), its threads,
    outputs per thread and ring; the MHD kinds and rank 1 keep the
    one-tile body, and the rules the temporal kernel enforces stay."""
    ops, plan, _ = _plan((64, 64, 64), 6, 2)
    assert plan.persistent and not plan.swc_depth1
    assert plan.threads == tplan.WALK_THREADS["select"]
    _, f64, _ = _plan((64, 64, 64), 6, 2, dtype="float64")
    assert f64.threads == tplan.WALK_THREADS["select", "float64"]
    assert plan.outputs_per_thread == tplan.WALK_OUTPUTS["select"]
    assert plan.stage_buffers == tplan.WALK_STAGES["select"]
    many = dataclasses.replace(plan, batch=70_000)
    assert many.walk_items == 70_000 * plan.walk_items
    g = emit.geometry(plan, [0])
    assert g[12:15].tolist() == list(plan.block)
    assert g[19:23].tolist() == [2, plan.stage_buffers, plan.threads,
                                 plan.segments]
    assert g[-1] == tplan.WALK_OUTPUTS["select"]  # nonzero: the walk
    assert emit.kernel_name(plan) == emit.TEMPORAL_KERNEL
    # Rank 2: lifted to (Y, 1, X) in the geometry, as swc_stream's.
    _, two, _ = _plan((64, 128), 4, 3)
    g = emit.geometry(two, [0])
    assert g[3:6].tolist() == [64, 1, 128] and g[9:12].tolist() == [2, 0, 2]
    # Not the walk: rank 1, the MHD kinds in f64; bf16 raises.
    one = tplan.plan_stencil(ts.derivative_operator_set(1, 2), (1, 68), 1,
                             fuse_steps=2)
    assert not one.temporal_walk and not one.persistent
    assert one.threads == 66 and emit.geometry(one, [0])[-1] == 0  # 64 + 2r
    mhd = ts.derivative_operator_set(3, 6)
    for dtype, walk in (("float32", True), ("float64", False)):
        pair = plan_for_nd(mhd, (8, 76, 76, 76), 16,
                           aux_shape=(8, 70, 70, 70), fuse_steps=2,
                           max_threads=256, n_slots=10, dtype=dtype)
        assert pair.temporal_walk == walk
    assert pair.block == (1, 2, 32)  # f64: (1, 8, 32) halved to fit
    # The f32 MHD kinds: 512 threads, one output each, one step of planes
    # in the input ring, phi's inputs for WALK_MHD_BATCH points.
    for n_out, aux in ((16, (8, 70, 70, 70)), (8, None)):
        mplan = plan_for_nd(mhd, (8, 76, 76, 76), n_out, aux_shape=aux,
                            fuse_steps=2, max_threads=256, n_slots=10)
        assert mplan.temporal_walk and mplan.block == (1, 4, 16)
        assert (mplan.threads, mplan.outputs_per_thread,
                mplan.stage_buffers) == (512, 1, 1)
        assert emit.geometry(mplan, list(range(10)))[-1] == 1
    # bf16 walks (B2c), with 2-byte rings
    bf = tplan.plan_stencil(ops, (1, 76, 76, 76), 1, fuse_steps=2,
                            dtype="bfloat16")
    assert bf.temporal_walk and bf.block == (4, 32, 32)
    assert bf.walk_ring.inp.ring_bytes < tplan.plan_stencil(
        ops, (1, 76, 76, 76), 1, fuse_steps=2).walk_ring.inp.ring_bytes
    with pytest.raises(ValueError, match="self-map"):
        tplan.plan_stencil(ts.derivative_operator_set(3, 2), (2, 20, 20, 20),
                           3, fuse_steps=2)
    with pytest.raises(ValueError, match="unroll"):
        tplan.plan_stencil(ops, (1, 76, 76, 76), 1, fuse_steps=2, unroll=2)


def test_walk_tiles_segments_and_fit():
    """The planner's tiles (f32 at depth 2 and 3, f64, rank 2), a tile
    halved along y, then its step, then x until the rings fit, segments
    that give MIN_WALK_ITEMS columns while each stays 8 halos long, and a
    depth that fits no tile."""
    _, f32, _ = _plan((512,) * 3, 6, 2)
    assert f32.block == tplan.DEFAULT_WALK_BLOCKS3["float32", 2]
    assert f32.block == (4, 32, 32) and f32.threads == 512
    assert f32.segments == 4 and f32.walk_items == 4 * 16 * 16
    assert f32.walk_items >= tplan.MIN_WALK_ITEMS
    _, deep, _ = _plan((512,) * 3, 6, 3)
    assert deep.block == tplan.DEFAULT_WALK_BLOCKS3["float32", 3]
    _, f64, _ = _plan((256,) * 3, 6, 2, dtype="float64")
    assert f64.block == (4, 16, 32) and f64.threads == 256
    _, f64, _ = _plan((256,) * 3, 6, 3, dtype="float64")
    assert tplan.DEFAULT_WALK_BLOCKS3["float64", 3] == (2, 16, 32)
    assert f64.block == (2, 8, 32) and f64.segments == 1  # y halved
    _, two, _ = _plan((512, 400), 6, 2)
    assert tplan.DEFAULT_WALK_BLOCK2 == (4, 256)
    assert two.block == (4, 200)  # clamped to divisors
    _, big, _ = _plan((64, 64, 256), 6, 3, block=(4, 64, 256))
    assert big.smem_bytes <= tplan.SMEM_PER_BLOCK
    assert big.block[1] < 64
    # An MHD tile over what fits ends narrow in x once y and the step are 1.
    mhd = ts.derivative_operator_set(3, 6)
    pair = plan_for_nd(mhd, (8, 28, 36, 44), 16, aux_shape=(8, 22, 30, 38),
                       block=(1, 8, 32), fuse_steps=2, max_threads=256,
                       n_slots=10)
    assert pair.block == (1, 1, 16)
    ops = DiffusionProblem((64,) * 3).step_op("swc", device=CPU).ops
    with pytest.raises(ValueError, match="no tile fits"):
        tplan.plan_stencil(ops, (1,) + (64 + 54,) * 3, 1, fuse_steps=9)
    with pytest.raises(ValueError, match="segments"):
        dataclasses.replace(f32, segments=3)


def test_solver_leaves_the_temporal_tile_to_the_planner():
    """MHDSolver passes no tile on swc at depth > 1: the planner's own, the
    walk's (1, 4, 16) in f32, and on the one-tile body in f64 the pair's
    (1, 8, 32) halved to fit."""
    for dtype, block in (("float32", (1, 4, 16)), ("float64", (1, 2, 32))):
        s = tmhd.MHDSolver((32, 32, 64), strategy="swc",
                           fuse_rk_pairs=True, device=CPU)
        op = s._fused_pair_op(1e-3)
        assert op.block is None
        f = torch.zeros((8,) + tuple(n + 12 for n in s.shape),
                        dtype=getattr(torch, dtype))
        plan = plan_for_nd(op.ops, tuple(f.shape), 16,
                           aux_shape=(8, 38, 38, 70), strategy="swc",
                           dtype=dtype, fuse_steps=2, max_threads=256,
                           n_slots=10)
        assert plan.block == block


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("shape", ((96, 120), (24, 40, 56)))
@pytest.mark.parametrize("depth", (2, 3, 9))
def test_walk_select_matches_plain_on_card(cuda_device, shape, depth,
                                           dtype):
    order = 2 if depth == 9 else 6
    ops, plan, padded = _plan(shape, order, depth, dtype=dtype)
    if depth == 9 and len(shape) == 3:
        ops, plan, padded = _plan(shape, order, depth, dtype=dtype,
                                  block=(1, 8, 8))
    assert emit.kernel_smem_bytes(plan) == plan.smem_bytes
    g = torch.Generator().manual_seed(1)
    fp = torch.rand(padded, generator=g, dtype=torch.float64).to(
        cuda_device, getattr(torch, dtype))
    phi = select_phi(ops.names[0])
    emit.reset_launch_counts()
    got = emit.fused_stencil_swc(fp, ops, phi, plan)
    assert emit.fused_stencil_swc.launches_by_depth == {depth: 1}
    want = ref.fused_stencil_steps(fp, ops, phi.torch_fn, depth)
    assert _rel(got.cpu(), want.cpu()) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ("swc", "swc_stream"))
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("shape", ((96, 120), (24, 40, 56)))
@pytest.mark.parametrize("depth", (2, 3))
def test_walk_of_both_strategies_matches_plain_on_card(
        cuda_device, shape, depth, dtype, strategy):
    """Each strategy's walk launch within its tolerance of the plain
    version, under its own kernel's name and count, and the two launches
    equal bit for bit (one body)."""
    ops, plan, padded = _plan(shape, 6, depth, dtype=dtype,
                              strategy=strategy)
    assert emit.kernel_smem_bytes(plan) == plan.smem_bytes
    g = torch.Generator().manual_seed(4)
    fp = torch.rand(padded, generator=g, dtype=torch.float64).to(
        cuda_device, getattr(torch, dtype))
    phi = select_phi(ops.names[0])
    emit.reset_launch_counts()
    got = emit.fused_stencil_swc(fp, ops, phi, plan)
    assert emit.fused_stencil_swc.launches_by_kernel == {
        emit.kernel_name(plan): 1}
    want = ref.fused_stencil_steps(fp, ops, phi.torch_fn, depth)
    assert _rel(got.cpu(), want.cpu()) <= TOL[dtype]
    other = dataclasses.replace(plan, strategy="swc" if strategy != "swc"
                                else "swc_stream")
    assert torch.equal(got, emit.fused_stencil_swc(fp, ops, phi, other))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("segments", (1, 4))
def test_walk_segments_and_members_on_card(cuda_device, segments, dtype):
    """Segments forced to 1 and 4, three members: the batched launch
    equals the plain version, and each member its unbatched launch
    exactly."""
    ops, plan, padded = _plan((64, 24, 40), 6, 2, dtype=dtype, batch=3,
                              n_f=2, segments=segments)
    g = torch.Generator().manual_seed(2)
    fp = torch.rand(padded, generator=g, dtype=torch.float64).to(
        cuda_device, getattr(torch, dtype))
    phi = select_phi("dxx")
    got = emit.fused_stencil_swc(fp, ops, phi, plan)
    want = ref.fused_stencil_steps_batched(fp, ops, phi.torch_fn, 2)
    assert _rel(got.cpu(), want.cpu()) <= TOL[dtype]
    solo = dataclasses.replace(plan, batch=1)
    for m in range(3):
        assert torch.equal(got[m], emit.fused_stencil_swc(fp[m], ops, phi,
                                                          solo))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_mhd_rhs_twice_matches_plain_on_card(cuda_device, dtype):
    """The MHD RHS applied twice in one depth-2 launch (the walk in f32,
    the one-tile body in f64)."""
    solver = tmhd.MHDSolver((16, 24, 32), strategy="swc", device=cuda_device)
    f = solver.init_smooth(0, amplitude=1e-2, dtype=dtype)
    fp = pad(f, 6, "periodic", spatial_axes=(1, 2, 3))
    phi = tmhd.mhd_rhs_device_phi(solver.params)
    got = fused_stencil_nd(fp, solver.operator_set, phi, 8, strategy="swc",
                           fuse_steps=2)
    want = ref.fused_stencil_steps(fp, solver.operator_set, phi.torch_fn, 2)
    assert _rel(got.cpu(), want.cpu()) <= TOL[dtype]
