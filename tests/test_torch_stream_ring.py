"""The depth-1 stream kernel's ring body (B3, ``csrc/stream_body.cuh``):
its host side on the CPU — the ring's slot arithmetic and fetch schedule,
the per-slot tap rows, the shared-memory layout, the staging into rows
congruent to the padded field's modulo 16 bytes, the planner's rules —
and, on the card, the kernel against its plain version.

The ring tests mirror the kernel in numpy: plane j of a column's segment
goes to slot j mod P; a window row (j, y) of field k starting ``a``
elements into its first 16 bytes goes to ring element ``b = k fstride +
s0 + slot plane + y pitch`` (``b = a`` mod V), chunk q from ``q V - a`` of
the row to ``b - a + q V``; a point whose plane sits in slot q reads tap
t at its centre plus row q's offset. Replaying the fetch schedule
(``plan.stream_schedule``) over a whole column, every read must see the
padded field's values. Tolerances on the card: f32 1e-5 and f64 1e-12
relative to the largest |value|; a member of a batched launch equals its
unbatched launch exactly. The port against the JAX package on this path
is ``test_torch_stream.py``'s.
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
from repro_torch.physics import mhd as tmhd
from repro_torch.physics.diffusion import DiffusionProblem

TOL = {"float32": 1e-5, "float64": 1e-12}


def _diffusion(shape, order):
    """The diffusion step's one operator (19 taps at order 6 in 3-D)."""
    return DiffusionProblem(shape, accuracy=order).step_op(
        "swc", device="cpu").ops


def _plan(shape, order, *, n_f=1, batch=None, dtype="float32", block=None,
          segments=None, n_slots=1, ops=None):
    if ops is None:
        ops = ts.derivative_operator_set(len(shape), order, 0.3)
    r = ops.radius_per_axis()
    lead = (n_f,) if batch is None else (batch, n_f)
    padded = lead + tuple(n + 2 * q for n, q in zip(shape, r))
    plan = tplan.plan_stencil(ops, padded, n_f if n_slots == 1 else 8,
                              strategy="swc_stream", block=block,
                              dtype=dtype, n_slots=n_slots)
    if segments is not None:
        plan = dataclasses.replace(plan, segments=segments)
    return ops, plan


def _columns(plan):
    """Every block's column: (member, first padded plane of its segment
    window, y0, x0), the kernel's grid (x tiles, y tiles, members x
    segments) lifted as the kernel sees rank 2."""
    tz, ty, tx = tplan._stream3(plan.block, 1)
    _, ny, nx = tplan._stream3(plan.interior, 1)
    per_seg = plan.n_chunks // plan.segments * tz
    return [(m, s * per_seg, iy * ty, ix * tx)
            for m in range(plan.batch) for s in range(plan.segments)
            for iy in range(ny // ty) for ix in range(nx // tx)]


# --- the ring's slots and the fetch schedule ------------------------------------


@pytest.mark.parametrize("shape,order,kw", (
    ((160, 40), 4, dict(block=(8, 40))),              # rank 2, 3 stages
    ((160, 40), 4, dict(block=(8, 40), segments=4, batch=3)),
    ((48, 8, 32), 6, dict(block=(4, 8, 32))),         # rank 3, radius 3
    ((48, 8, 32), 6, dict(block=(2, 8, 32), segments=3, batch=3)),
    ((24, 8, 32), 6, dict(block=(1, 8, 32), n_f=8, n_slots=10)),  # MHD
    ((30, 10, 12), 2, dict(block=(3, 5, 12), dtype="float64")),
))
def test_ring_schedule_lands_every_plane_once_and_reads_each_window(
    shape, order, kw
):
    """The mirror of the ring's walk: for every column (segments and
    members included) each plane of its segment's window lands once, in
    slot j mod P; at each read, chunk c's window holds planes c tau0 ...
    c tau0 + tau0 + 2h0 - 1 (no fetch in flight overwrote one); and each
    tap row of the slots a chunk's points sit in reaches the planes the
    tap's dz names."""
    ops, plan = _plan(shape, order, **kw)
    assert plan.stream_depth1
    assert audit_plan(plan, ops).findings == []  # the static auditor too
    ring = plan.stream_ring
    tz, lead, period = ring.chunk[0], ring.lead, ring.period
    r0 = lead // 2
    assert period >= plan.stage_buffers * tz + lead
    assert period * ring.plane % (16 // tplan.ITEMSIZE[plan.dtype]) == 0
    offsets = emit.tap_table(ops)[0].tolist()
    rows = tplan.stream_tap_rows(ring, plan.radii, offsets)
    dzs = sorted({(dz + dy) if plan.rank == 2 else dz
                  for dz, dy, _ in offsets})
    events = tplan.stream_schedule(plan)
    chunks = plan.n_chunks // plan.segments
    landed_all = []
    for member, z_first, _, _ in _columns(plan):
        slots, landed, reads = {}, [], 0
        for kind, i, data in events:
            if kind == "fetch":
                for j, slot in data:
                    assert slot == j % period
                    slots[slot] = j
                    landed.append(j)
                continue
            reads += 1
            want = list(range(i * tz, i * tz + tz + lead))
            got = [slots.get((data + n) % period) for n in range(tz + lead)]
            assert got == want, (i, got, want)
            for zq in range(tz):  # the tap rows of each output plane
                q = (data + zq + r0) % period
                for dz in dzs:
                    at = (q + dz) % period
                    assert slots[at] == i * tz + zq + r0 + dz
        assert reads == chunks
        assert sorted(landed) == list(range(chunks * tz + lead))
        landed_all += [(member, z_first + j) for j in landed]
    # The segments of a column cover its stream axis once, each with its
    # own 2h0 leading planes.
    per_column = chunks * tz + lead
    assert len(landed_all) == len(_columns(plan)) * per_column
    # Row q of the tap table: (slot of the plane dz away - q) plane + dy
    # pitch + dx.
    for q in (0, period - 1):
        for (dz, dy, dx), off in zip(offsets, rows[q]):
            if plan.rank == 2:
                dz, dy = dz + dy, 0
            assert off == ((q + dz) % period - q) * ring.plane + (
                dy * ring.pitch + dx)


# --- the layout -------------------------------------------------------------------


def test_ring_smem_bytes_is_the_layout():
    """plan.smem_bytes against ring_layout of csrc/stream_body.cuh, counted
    by hand: the ring of all fields, one tap row per slot (coefficient and
    int32 offset, twice the itemsize), the int32 operator starts and, for
    MHD, φ's inputs from a 16-byte boundary."""
    # 512^3 f32 order 6 at the planner's (8, 16, 32): window 22 x 38; a
    # row of 38 + 3 congruent to 518 = 2 (mod 4): pitch 42; plane 22 x 42
    # = 924 = 518^2 (mod 4); 3 chunks and 6 carried planes: P = 30; a
    # field reaches element 3 + 29 x 924 + 21 x 42 + 38 = 27,719, 27,720
    # elements.
    _, big = _plan((512, 512, 512), 6, ops=_diffusion((512,) * 3, 6))
    ring = big.stream_ring
    assert big.block == tplan.DEFAULT_STREAM_D1_BLOCKS[3] == (8, 16, 32)
    assert (big.stage_buffers, ring.pitch, ring.plane, ring.period) == (
        3, 42, 924, 30)
    assert ring.field_stride == 27_720 and ring.ring_bytes == 110_880
    taps = 30 * 19 * 8 + 2 * 4  # 19 taps a row, one operator
    assert big.smem_bytes == 110_880 + taps == 115_448
    assert tplan.tc_blocks_per_sm(big.smem_bytes, big.threads) == 2
    # The 4096^2 order-2 serve launch (B = 8) at (32, 128): rows of 130 +
    # 3 congruent to 4098 = 2 (mod 4): pitch and plane 134; P = 3 x 32 + 2
    # = 98; 3 + 97 x 134 + 130 = 13,131 -> 13,132 elements; 32 cross tiles
    # x 8 members are under 264 blocks, so 2 segments.
    _, serve = _plan((4096, 4096), 2, batch=8,
                     ops=_diffusion((4096, 4096), 2))
    ring = serve.stream_ring
    assert serve.block == (32, 128) and serve.segments == 2
    assert serve.outputs_per_thread == 4  # 128 points a plane: one run
    assert (ring.pitch, ring.plane, ring.period, ring.field_stride) == (
        134, 134, 98, 13_132)
    assert serve.smem_bytes == 13_132 * 4 + 98 * 5 * 8 + 2 * 4 == 56_456
    # f64 at rank 3 takes (8, 8, 32): V = 2, pitch 38 + 1 -> 40 (= 262),
    # plane 14 x 40 = 560; three chunks would leave one block an SM, so
    # two: P = 22; 1 + 21 x 560 + 13 x 40 + 38 = 12,319 -> 12,320.
    _, f64 = _plan((256, 256, 256), 6, dtype="float64",
                   ops=_diffusion((256,) * 3, 6))
    ring = f64.stream_ring
    assert f64.block == tplan.DEFAULT_STREAM_D1_F64_BLOCK3 == (8, 8, 32)
    assert (f64.stage_buffers, ring.plane, ring.period) == (2, 560, 22)
    assert ring.field_stride == 12_320
    assert f64.smem_bytes == 12_320 * 8 + 22 * 19 * 16 + 8 == 105_256
    # Two fields, a ragged row: padded (.., 23, 41) f32 at (2, 3, 7),
    # radius 2: window 7 x 11, pitch 11 + 3 -> 14 (= 41 = 1 mod 4)... the
    # field stride keeps 41 x 23 x (z) mod 4.
    ops = ts.derivative_operator_set(3, 4, 0.3)
    two = tplan.plan_stencil(ops, (2, 24, 23, 41), 2, strategy="swc_stream",
                             block=(2, 3, 7))
    ring = two.stream_ring
    assert ring.pitch % 4 == 41 % 4 and ring.plane % 4 == (23 * 41) % 4
    assert ring.field_stride % 4 == (24 * 23 * 41) % 4
    assert two.smem_bytes == (-(-2 * ring.field_stride * 4 // 16) * 16
                              + ring.period * ops.taps_per_point * 8
                              + (ops.n_s + 1) * 4)


# --- the staging ------------------------------------------------------------------


def _replay(plan, ops, origin_member, field):
    """Replay a column's fetch schedule into a numpy ring as the kernel's
    cp.async copies do, 16 bytes at a time, checking each read against the
    padded field; ``field`` is the (batch, n_f, *padded) array, laid out
    from element 0 of 16-byte aligned memory, each element its own
    index."""
    ring = plan.stream_ring
    item = tplan.ITEMSIZE[plan.dtype]
    v = 16 // item
    pz, py, px = tplan._stream3(field.shape[2:], 1)
    psz, pfield = py * px, pz * py * px
    tz, ty, tx = ring.chunk
    wy, wx = ring.window
    r0z, r0y, r0x = tplan._stream3(plan.radii, 0)
    flat = field.reshape(-1)
    member, z_first, y0, x0 = origin_member
    sb = ((member * plan.n_f) * pfield + z_first * psz + y0 * px + x0)
    s0 = sb % v
    buf = np.full(plan.n_f * ring.field_stride + v, -1, np.int64)
    cq = -(-(wx + v - 1) // v)
    offsets = emit.tap_table(ops)[0].tolist()
    rows = tplan.stream_tap_rows(ring, plan.radii, offsets)
    reads = 0
    for kind, i, data in tplan.stream_schedule(plan):
        if kind == "fetch":
            for k in range(plan.n_f):
                sbk = sb + k * pfield
                for j, slot in data:
                    for y in range(wy):
                        a = (sbk + j * psz + y * px) % v
                        b = k * ring.field_stride + s0 + slot * ring.plane + (
                            y * ring.pitch)
                        assert (b - a) % v == 0
                        for q in range(cq):
                            if q * v >= a + wx:
                                continue
                            dst = b - a + q * v
                            src = sbk + j * psz + y * px - a + q * v
                            assert dst % v == 0 and src % v == 0
                            assert 0 <= dst and dst + v <= len(buf) - v
                            buf[dst:dst + v] = flat[src:src + v]
            continue
        reads += 1
        for k in range(plan.n_f):
            for zq in range(tz):
                q = (data + zq + r0z) % plan.stream_ring.period
                for y in range(ty):
                    for x in range(tx):
                        cen = (k * ring.field_stride + s0 + q * ring.plane
                               + (y + r0y) * ring.pitch + x + r0x)
                        for (dz, dy, dx), off in zip(offsets, rows[q]):
                            if plan.rank == 2:
                                dz, dy = dz + dy, 0
                            want = (sb + k * pfield
                                    + (i * tz + zq + r0z + dz) * psz
                                    + (y + r0y + dy) * px + x + r0x + dx)
                            assert buf[cen + off] == flat[want]
    return reads


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("rank", (2, 3))
def test_ring_staging_keeps_rows_congruent_at_a_ragged_pitch(dtype, rank):
    """Padded rows of 41 elements (164 or 328 bytes: no multiple of 16),
    two fields, a column at an offset within 16 bytes, a stream extent of
    several ring passes: every 16-byte copy is aligned on both sides, and
    every point of every chunk reads, through its tap row, the padded
    field's value its tap names."""
    if rank == 3:
        shape, block = (40, 9, 37), (2, 3, 37)
    else:
        shape, block = (60, 37), (3, 37)
    ops = _diffusion(shape, 4)
    r = ops.radius_per_axis()
    padded = (2, 2) + tuple(n + 2 * q for n, q in zip(shape, r))
    assert padded[-1] == 41
    plan = tplan.plan_stencil(ops, padded, 2, strategy="swc_stream",
                              block=block, dtype=dtype)
    assert plan.block == block and plan.stream_depth1
    assert audit_plan(plan, ops).findings == []  # the static auditor too
    field = np.arange(int(np.prod(padded))).reshape(padded)
    tiles = [c for c in _columns(plan) if c[0] == 1]  # member 1
    for column in (tiles[0], tiles[-1]):
        assert _replay(plan, ops, column, field) == plan.n_chunks
    assert plan.n_chunks * block[0] > 2 * plan.stream_ring.period


# --- the planner's rules ----------------------------------------------------------


def test_depth1_stream_plan_rules():
    """Depth 1 on swc_stream runs the ring body for select (f32, f64) and
    the f32 MHD RHS, with its kind's threads, outputs per thread and ring;
    the f64 MHD RHS keeps the one-buffer body as it was (depth > 1 walks:
    test_torch_temporal_walk.py); the geometry carries the outputs per
    thread, which select the body."""
    _, sel = _plan((64, 64, 64), 6)
    assert sel.stream_depth1 and not sel.persistent
    assert (sel.threads, sel.outputs_per_thread) == (
        tplan.STREAM_THREADS["select"], tplan.STREAM_OUTPUTS["select"])
    g = emit.geometry(sel, [0])
    assert g[20] == sel.stage_buffers and g[21] == sel.threads
    assert g[41:].tolist() == [0, 0, 4]
    _, two = _plan((64, 256), 6)
    assert two.block == tplan.DEFAULT_STREAM_D1_BLOCKS[2]
    # U is halved until a warp's run of 32 U points lies in one plane.
    for block, u in (((32, 128), 4), ((32, 64), 2), ((8, 8, 32), 4),
                     ((8, 4, 16), 2), ((2, 3, 7), 1)):
        assert tplan.stream_outputs(block, 1) == u
    assert tplan.stream_outputs((1, 8, 32), 10) == 1
    ops = ts.derivative_operator_set(3, 6)
    rhs = tplan.plan_stencil(ops, (8, 70, 70, 70), 8, strategy="swc_stream",
                             block=(1, 8, 32), n_slots=10)
    assert rhs.stream_depth1 and rhs.threads == tplan.STREAM_THREADS["mhd"]
    assert (rhs.outputs_per_thread, rhs.stage_buffers) == (1, 1)
    own = tplan.plan_stencil(ops, (8, 70, 70, 70), 8, strategy="swc_stream",
                             n_slots=10)
    assert own.block == tplan.STREAM_MHD_BLOCK
    f64 = tplan.plan_stencil(ops, (8, 70, 70, 70), 8, strategy="swc_stream",
                             block=(1, 8, 32), n_slots=10, dtype="float64",
                             max_threads=256)
    assert not f64.stream_depth1 and f64.stage_buffers == 1
    assert emit.geometry(f64, list(range(10)))[43] == 0
    deep = tplan.plan_stencil(ops, (8, 70, 70, 70), 8, strategy="swc_stream",
                              n_slots=10, dtype="float64", max_threads=256)
    assert not deep.stream_depth1 and deep.outputs_per_thread == 1
    assert not deep.walk and deep.block == (1, 4, 32)  # as before
    # A plan made for one φ kind refuses another (its layout follows it).
    with pytest.raises(ValueError, match="operator slot"):
        emit._slots_mismatch(sel, tmhd.mhd_rhs_device_phi(tmhd.MHDParams()))
    # A tile the ring cannot hold is halved (chunk first); one that no
    # tile holds raises.
    fit = tplan.plan_stencil(ts.derivative_operator_set(3, 6),
                             (1, 518, 518, 518), 1, strategy="swc_stream",
                             block=(64, 16, 32))
    assert fit.block[0] < 64 and fit.smem_bytes <= tplan.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="no swc_stream tile fits"):
        tplan.plan_stencil(ts.derivative_operator_set(3, 6),
                           (200, 70, 70, 70), 200, strategy="swc_stream")


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _field(shape, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.rand(shape, generator=g, dtype=torch.float64).to(
        device=device, dtype=getattr(torch, dtype))


def _close(got, want, dtype):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("shape,block", (
    ((96, 200), None), ((300, 35), (3, 35)),
    ((20, 24, 40), None), ((48, 18, 35), (2, 3, 7)),
))
def test_ring_select_matches_plain_on_card(cuda_device, shape, block, dtype):
    """select (two fields, φ = dxx) at ranks 2 and 3, on the planner's tile
    and on a ragged one (rows of 41 elements, chunks of 21 points for
    1024 thread outputs), over several ring passes."""
    ops = ts.derivative_operator_set(len(shape), 6, 0.3)
    fp = _field((2,) + tuple(n + 6 for n in shape), dtype, cuda_device)
    plan = plan_for_nd(ops, tuple(fp.shape), 2, strategy="swc_stream",
                       block=block, dtype=dtype)
    assert plan.stream_depth1
    assert emit.kernel_smem_bytes(plan) == plan.smem_bytes
    before = emit.fused_stencil_swc.launches_by_kernel["fused_stencil_stream"]
    got = emit.fused_stencil_swc(fp, ops, select_phi("dxx"), plan)
    assert emit.fused_stencil_swc.launches_by_kernel[
        "fused_stencil_stream"] == before + 1
    _close(got, ref.fused_stencil(fp, ops, lambda d: d["dxx"]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", (1, 4))
def test_ring_segments_match_plain_on_card(cuda_device, segments):
    ops = ts.derivative_operator_set(3, 4, 0.3)
    fp = _field((1, 68, 20, 36), "float64", cuda_device)
    plan = dataclasses.replace(
        plan_for_nd(ops, tuple(fp.shape), 1, strategy="swc_stream",
                    block=(4, 16, 32), dtype="float64"),
        segments=segments)
    got = emit.fused_stencil_swc(fp, ops, select_phi("dxx"), plan)
    _close(got, ref.fused_stencil(fp, ops, lambda d: d["dxx"]), "float64")


@pytest.mark.cuda
def test_ring_mhd_rhs_matches_plain_on_card(cuda_device):
    solver = tmhd.MHDSolver((12, 24, 64), strategy="swc_stream",
                            device=cuda_device)
    f = solver.init_smooth(0, amplitude=1e-2, dtype="float32")
    fp = pad(f, 3, "periodic", spatial_axes=(1, 2, 3))
    phi = tmhd.mhd_rhs_device_phi(solver.params)
    plan = plan_for_nd(solver.operator_set, tuple(fp.shape), 8,
                       strategy="swc_stream", block=solver.block,
                       n_slots=len(phi.operators), max_threads=256)
    assert plan.stream_depth1
    got = emit.fused_stencil_swc(fp, solver.operator_set, phi, plan)
    _close(got, ref.fused_stencil(fp, solver.operator_set, phi.torch_fn),
           "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((64, 96), (16, 16, 64)))
def test_ring_members_equal_their_launch_on_card(cuda_device, shape):
    """B = 3 in one launch: each member equal to its unbatched launch bit
    for bit, and the batch to the batched plain version."""
    ops = ts.derivative_operator_set(len(shape), 6, 0.3)
    fp = _field((3, 1) + tuple(n + 6 for n in shape), "float32",
                cuda_device)
    plan = plan_for_nd(ops, tuple(fp.shape), 1, strategy="swc_stream")
    phi = select_phi("dxx")
    got = emit.fused_stencil_swc(fp, ops, phi, plan)
    solo = dataclasses.replace(plan, batch=1)
    for m in range(3):
        assert torch.equal(got[m], emit.fused_stencil_swc(fp[m], ops, phi,
                                                          solo))
    _close(got, ref.fused_stencil_batched(fp, ops, lambda d: d["dxx"]),
           "float32")
