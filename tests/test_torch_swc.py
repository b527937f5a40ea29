"""The depth-1 ``swc`` kernel's body (B1, ``csrc/swc_body.cuh``): its
host side on the CPU — the persistent walk, the shared-memory layout, the
staging into buffers congruent to the global rows modulo 16 bytes, the
planner's rules for a persistent launch — and, on the card, the kernel
against its plain version.

The staging test mirrors the kernel's copy loop in numpy: a window row
(z, y) starting ``a`` elements into its first 16 bytes goes to buffer
element ``b = s0 + z plane + y pitch`` (``b = a`` mod V), chunk q from
``q V - a`` of the row to ``b - a + q V``. Tolerances on the card: f32
1e-5 and f64 1e-12 relative to the largest |value|, bf16 equal (the
kernel rounds each product and sum as the plain version does); a member
of a batched launch equals its unbatched launch exactly. The port
against the JAX package on this path is ``test_torch_fused.py``'s.
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

TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 0.0}


# --- the walk -------------------------------------------------------------------


@pytest.mark.parametrize("shape,block,unroll,batch,grid", (
    ((6144,), (256,), 1, 1, 5),         # rank 1: 12 tiles a step, 2 steps
    ((6144,), (256,), 2, 3, 7),         # unroll 2: 6 tiles of 512, 6 steps
    ((48, 40), (16, 8), 1, 3, 7),       # 45 steps on 7 blocks
    ((8, 12, 40), (4, 4, 8), 1, 1, 4),  # 30 steps on 4 blocks
    ((8, 12, 40), (4, 4, 4), 2, 3, 13),  # 90 steps on 13 blocks
))
def test_swc_walk_covers_every_tile_once(shape, block, unroll, batch, grid):
    """The mirror of the depth-1 swc kernel's walk: block b takes steps b,
    b + grid, ...; together they cover every (member, z, y, x) tile once,
    even when the steps are no multiple of the grid."""
    ops = ts.derivative_operator_set(len(shape), 2, 0.3)
    padded = (batch, 1) + tuple(n + 2 for n in shape)
    plan = tplan.plan_stencil(ops, padded, 1, block=block, unroll=unroll)
    assert plan.block == block and plan.persistent
    assert audit_plan(plan, ops).findings == []  # the static auditor too
    assert plan.walk_items % grid
    walks = tplan.persistent_walk(plan, grid)
    tz, ty, tx = tplan._lift3(block[:-1] + (plan.x_step,), 1)
    seen = [(m, z0, y0, x0 + i * tx) for steps in walks
            for m, z0, y0, x0 in steps for i in range(plan.tiles_per_step)]
    nz, ny, nx = (n // t for n, t in zip(tplan._lift3(shape, 1), (tz, ty, tx)))
    want = [(m, iz * tz, iy * ty, ix * tx) for m in range(batch)
            for iz in range(nz) for iy in range(ny) for ix in range(nx)]
    assert sorted(seen) == want
    assert len(seen) == len(set(seen))
    assert max(map(len, walks)) - min(map(len, walks)) == 1
    if len(shape) == 1:  # the most tiles within SWC_STEP_POINTS
        assert plan.tiles_per_step == 12 // unroll


# --- the layout ------------------------------------------------------------------


def test_swc_smem_bytes_is_the_layout():
    """plan.smem_bytes against swc_layout of csrc/swc_body.cuh, counted by
    hand: the ring, the tap table (coefficient and int32 offset, twice the
    itemsize), the int32 operator starts and, for MHD, φ's inputs from a
    16-byte boundary."""
    ops = ts.derivative_operator_set(3, 6)  # 10 operators, 148 taps
    # f32 select on (64,)^3, padded 70: window (10, 14, 38); V = 4 and a
    # padded row of 70 = 2 (mod 4) elements: pitch 42 >= 38 + 3, 42 = 2;
    # plane 14 x 42 = 588 = 4900 (mod 4); the buffer reaches element 3 +
    # 9 x 588 + 13 x 42 + 38 = 5879, 1470 chunks of 16 B.
    p = tplan.plan_stencil(ops, (2, 70, 70, 70), 2, block=(4, 8, 32))
    step = p.swc_step
    assert (p.block, step.window, step.pitch, step.plane) == (
        (4, 8, 32), (10, 14, 38), 42, 588)
    assert step.buffer_bytes == 1470 * 16 and p.stage_buffers == 3
    assert p.smem_bytes == 3 * 23_520 + 148 * 8 + 11 * 4 == 71_788
    # bf16 (V = 8): pitch 46 >= 38 + 7, 46 = 70 (mod 8); plane 644 = 4900.
    b = tplan.plan_stencil(ops, (2, 70, 70, 70), 2, dtype="bfloat16",
                           block=(4, 8, 32))
    assert (b.swc_step.pitch, b.swc_step.plane) == (46, 644)
    assert b.smem_bytes == 3 * b.swc_step.buffer_bytes + 148 * 8 + 44
    # The planner's own select tile is (8, 16, 32): a window of 14 x 22
    # x 38 reaching element 3 + 13 x 924 + 21 x 42 + 38 = 12,935, 3,234
    # chunks; three stages would leave one block an SM, so two.
    own = tplan.plan_stencil(ops, (2, 70, 70, 70), 2)
    assert own.block == tplan.DEFAULT_SWC_BLOCKS[3] == (8, 16, 32)
    assert own.swc_step.plane == 924 and own.stage_buffers == 2
    assert own.swc_step.buffer_bytes == 3_234 * 16
    assert own.smem_bytes == 2 * 51_744 + 148 * 8 + 44
    # f64 keeps (4, 8, 32), with two stages: three would leave one block.
    d64 = tplan.plan_stencil(ops, (2, 70, 70, 70), 2, dtype="float64")
    assert (d64.block, d64.stage_buffers) == ((4, 8, 32), 2)
    # MHD f32 at the planner's (2, 8, 32): 512 threads, a ring of two, and
    # after the starts (padded to 16 B) 10 x 8 values per point.
    rhs = tplan.plan_stencil(ops, (8, 70, 70, 70), 8, n_slots=10)
    assert rhs.block == tplan.SWC_MHD_BLOCK["float32"] == (2, 8, 32)
    assert (rhs.threads, rhs.stage_buffers) == (512, 2)
    head = 2 * rhs.swc_step.buffer_bytes + 148 * 8 + 44
    assert rhs.smem_bytes == -(-head // 16) * 16 + 10 * 8 * 512 * 4
    # f64 MHD: 256 threads, (1, 8, 32), the inputs in f64.
    f64 = tplan.plan_stencil(ops, (8, 70, 70, 70), 8, n_slots=10,
                             dtype="float64")
    assert (f64.block, f64.threads) == ((1, 8, 32), 256)
    head = 2 * f64.swc_step.buffer_bytes + 148 * 16 + 44
    assert f64.smem_bytes == -(-head // 16) * 16 + 10 * 8 * 256 * 8
    assert f64.smem_bytes <= tplan.SMEM_PER_BLOCK


def _stage(n_pad, window, origin, itemsize, pitch, plane, buffer_elems):
    """Mirror of swc_body.cuh's stage(): copy the window at ``origin`` of
    a padded (z, y, x) field laid out from element 0 of 16-byte aligned
    memory into a buffer, 16 bytes at a time; returns the buffer (-1
    where nothing landed) and the chunks as (dst, src, row) triples."""
    v = 16 // itemsize
    pz, py, px = n_pad
    wz, wy, wx = window
    psy, psz = px, px * py
    field = np.arange(pz * psz)  # each element holds its own index
    sb = origin[0] * psz + origin[1] * psy + origin[2]
    s0 = sb % v
    cq = -(-(wx + v - 1) // v)
    buf = np.full(buffer_elems, -1)
    chunks = []
    for row in range(wz * wy):
        z, y = divmod(row, wy)
        a = (sb + z * psz + y * psy) % v
        b = s0 + z * plane + y * pitch
        assert (b - a) % v == 0
        for q in range(cq):
            if q * v >= a + wx:
                continue
            dst, src = b - a + q * v, sb + z * psz + y * psy - a + q * v
            assert dst % v == 0 and src % v == 0  # 16-byte aligned both
            assert 0 <= dst and dst + v <= buffer_elems
            buf[dst:dst + v] = field[src:src + v]
            chunks.append((dst, src, row))
    return buf, chunks, s0, sb


@pytest.mark.parametrize("dtype", ("float32", "float64", "bfloat16"))
@pytest.mark.parametrize("origin", ((0, 0, 0), (1, 2, 3), (2, 5, 7)))
def test_swc_rows_keep_their_16_byte_alignment(dtype, origin):
    """Padded rows of 41 elements (164, 328 or 82 bytes: no multiple of
    16) and planes of 41 x 23: every 16-byte copy is aligned on both
    sides, no two rows' copies meet, and window point (z, y, x) lands at
    s0 + z plane + y pitch + x, so one linear offset per tap reads it."""
    item = tplan.ITEMSIZE[dtype]
    n_pad = (12, 23, 41)
    ops = ts.derivative_operator_set(3, 4)
    radii = ops.radius_per_axis()
    block = (3, 4, 8)
    step = tplan.swc_step(block, radii, n_pad, 3, dtype)
    v = 16 // item
    assert (41 * item) % 16 and step.pitch % v == 41 % v
    assert step.plane % v == (41 * 23) % v
    buf, chunks, s0, sb = _stage(n_pad, step.window, origin, item,
                                 step.pitch, step.plane,
                                 step.buffer_bytes // item)
    dsts = [d for d, _, _ in chunks]
    assert len(dsts) == len(set(dsts))  # no chunk written twice
    wz, wy, wx = step.window
    for z in range(wz):
        for y in range(wy):
            at = s0 + z * step.plane + y * step.pitch
            want = sb + z * 41 * 23 + y * 41 + np.arange(wx)
            assert np.array_equal(buf[at:at + wx], want)
    # A tap (dz, dy, dx) of point (z, y, x) sits at one linear offset.
    for dz, dy, dx in ((-2, 1, 2), (0, -2, -1), (2, 2, 2)):
        off = dz * step.plane + dy * step.pitch + dx
        z, y, x = 2, 2, 2  # window point of output (0, 0, 0) shifted by r
        at = s0 + z * step.plane + y * step.pitch + x
        assert buf[at + off] == sb + (z + dz) * 943 + (y + dy) * 41 + x + dx


# --- the planner's rules ------------------------------------------------------


def test_swc_plan_rules_for_the_persistent_kernel():
    """Depth 1 on swc is persistent: neither gridDim.z nor one thread per
    point binds it (as for tc at depth 1), and nothing else is relaxed:
    the temporal kernel keeps both limits it had."""
    ops = ts.derivative_operator_set(3, 2)
    plan = tplan.plan_stencil(ops, (1, 34, 34, 34), 1, block=(32, 8, 32))
    assert plan.persistent and plan.swc_depth1 and not plan.tc_depth1
    assert plan.block == (32, 8, 32)  # 8192 points, 256 threads
    assert plan.threads == tplan.SWC_THREADS["select"]
    many = dataclasses.replace(plan, batch=70_000)  # past 65,535 z blocks
    assert many.grid_z > tplan.MAX_GRID_Z and many.walk_items == 70_000 * 4
    with pytest.raises(ValueError, match="gridDim.z"):
        dataclasses.replace(many, fuse_steps=2, n_slots=10, dtype="float64")
    # At depth 2 the select kind takes the temporal walk (persistent too);
    # a φ of several operators keeps the one-tile body.
    deep = tplan.plan_stencil(ops, (1, 36, 36, 36), 1, fuse_steps=2)
    assert deep.persistent and deep.temporal_walk
    assert deep.tiles_per_step == 1 and not deep.swc_depth1
    one_tile = dataclasses.replace(deep, n_slots=10, dtype="float64")
    assert not one_tile.persistent and one_tile.tiles_per_step == 1
    assert one_tile.outputs_per_thread == 1 and one_tile.stage_buffers <= 2
    stream = tplan.plan_stencil(ops, (1, 34, 34, 34), 1,
                                strategy="swc_stream")
    assert not stream.persistent
    # An explicit tile that does not fit is refused; the planner's own is
    # halved until it fits (f64 MHD at order 8: 9 x 16 x 40 windows).
    big = ts.derivative_operator_set(3, 8)
    with pytest.raises(ValueError, match="shared memory"):
        tplan.plan_stencil(big, (8, 72, 72, 72), 8, n_slots=10,
                           dtype="float64", block=(1, 8, 32))
    fit = tplan.plan_stencil(big, (8, 72, 72, 72), 8, n_slots=10,
                             dtype="float64")
    assert fit.block == (1, 4, 32) and fit.smem_bytes <= tplan.SMEM_PER_BLOCK
    # The geometry carries the walk: tiles per step and outputs per thread.
    one = tplan.plan_stencil(ts.derivative_operator_set(1, 6), (1, 8198), 1)
    assert one.tiles_per_step == 4 and one.x_step == 1024
    g = emit.geometry(one, [0])
    assert g[41:].tolist() == [4, 0, tplan.SWC_OUTPUTS["select"]]
    assert g[21] == one.threads


def test_mhd_swc_tile_is_the_planners():
    """MHDSolver leaves the swc kernels' tile to their planner at every
    depth: depth 1 (φ's inputs sit in shared memory) and the pair at depth
    2: in f32 the walk's (its φ inputs in shared memory too), in f64 the
    one-tile body's, which holds them in registers and takes the (1, 8,
    32) the solver used to pass, halved to fit."""
    solver = tmhd.MHDSolver((16, 16, 32), strategy="swc", device="cpu")
    assert solver.rhs_op().block is None
    pair = tmhd.MHDSolver((16, 16, 32), strategy="swc", device="cpu",
                          fuse_rk_pairs=True)
    op = pair._fused_pair_op(1e-3)
    assert op.block is None
    for dtype, block in (("float32", tplan.DEFAULT_WALK_MHD_BLOCK),
                         ("float64", (1, 2, 32))):
        plan = plan_for_nd(op.ops, (8, 28, 28, 44), 16,
                           aux_shape=(8, 22, 22, 38), fuse_steps=2,
                           max_threads=256, n_slots=10, dtype=dtype)
        assert plan.block == block and plan.temporal_walk == (
            dtype == "float32")


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


def _check(got, want, dtype):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    if dtype == "bfloat16":
        assert torch.equal(got, want)
        return
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64", "bfloat16"))
@pytest.mark.parametrize("shape", ((30000,), (96, 200), (20, 24, 40)))
def test_swc_select_matches_plain_on_card(cuda_device, shape, dtype):
    """select (two fields, φ = dxx) at ranks 1-3 against the plain
    version: f32/f64 within tolerance, bf16 equal."""
    ops = ts.derivative_operator_set(len(shape), 6, 0.3)
    fp = _field((2,) + tuple(n + 6 for n in shape), dtype, cuda_device)
    plan = plan_for_nd(ops, tuple(fp.shape), 2, dtype=dtype)
    assert plan.persistent
    assert emit.kernel_smem_bytes(plan) == plan.smem_bytes
    before = emit.fused_stencil_swc.launches_by_kernel["fused_stencil"]
    got = emit.fused_stencil_swc(fp, ops, select_phi("dxx"), plan)
    assert emit.fused_stencil_swc.launches_by_kernel["fused_stencil"] == (
        before + 1)
    _check(got, ref.fused_stencil(fp, ops, lambda d: d["dxx"]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("substep", (False, True))
def test_swc_mhd_matches_plain_on_card(cuda_device, substep, dtype):
    """The MHD RHS and fused substep at the planner's tile (φ's inputs in
    shared memory) against the plain version."""
    solver = tmhd.MHDSolver((16, 24, 64), strategy="swc", device=cuda_device)
    f = solver.init_smooth(0, amplitude=1e-2, dtype=dtype)
    fp = pad(f, 3, "periodic", spatial_axes=(1, 2, 3))
    if substep:
        phi = tmhd.mhd_substep_device_phi(solver.params, -5 / 9, 15 / 16,
                                          1e-2)
        aux, n_out = 1e-3 * torch.ones_like(f), 16
    else:
        phi, aux, n_out = tmhd.mhd_rhs_device_phi(solver.params), None, 8
    got = fused_stencil_nd(fp, solver.operator_set, phi, n_out, aux=aux,
                           strategy="swc")
    want = ref.fused_stencil(fp, solver.operator_set, phi.torch_fn, aux=aux)
    _check(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", ((4096,), (40, 96), (12, 16, 64)))
def test_swc_members_equal_their_launch_on_card(cuda_device, shape, dtype):
    """B = 3 in one launch: each member equal to its unbatched launch bit
    for bit, and the batch to the batched plain version."""
    ops = ts.derivative_operator_set(len(shape), 6, 0.3)
    fp = _field((3, 1) + tuple(n + 6 for n in shape), dtype, cuda_device)
    plan = plan_for_nd(ops, tuple(fp.shape), 1, dtype=dtype)
    phi = select_phi("dxx")
    got = emit.fused_stencil_swc(fp, ops, phi, plan)
    solo = dataclasses.replace(plan, batch=1)
    for m in range(3):
        assert torch.equal(got[m], emit.fused_stencil_swc(fp[m], ops, phi,
                                                          solo))
    _check(got, ref.fused_stencil_batched(fp, ops, lambda d: d["dxx"]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64", "bfloat16"))
def test_swc_ragged_row_pitch_matches_plain_on_card(cuda_device, dtype):
    """Padded rows of 41 elements (no multiple of 16 bytes), a window at
    every offset within 16 bytes, unroll 2 and a tile whose last round is
    short of threads: the congruent staging against the plain version."""
    ops = ts.derivative_operator_set(3, 6, 0.3)
    fp = _field((2, 18, 24, 41), dtype, cuda_device, seed=1)
    plan = plan_for_nd(ops, tuple(fp.shape), 2, dtype=dtype,
                       block=(2, 3, 7), unroll=5)
    assert plan.block == (2, 3, 7) and plan.x_step == 35
    assert plan.swc_step.points == 210 < plan.threads * (
        plan.outputs_per_thread)
    got = emit.fused_stencil_swc(fp, ops, select_phi("dxx"), plan)
    _check(got, ref.fused_stencil(fp, ops, lambda d: d["dxx"]), dtype)
