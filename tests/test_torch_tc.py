"""The tensor-core regime ``tc`` in the port, and bfloat16 in the depth-1
``swc`` kernel (B1b), against the JAX package.

The JAX side runs as ``tests/test_tc.py`` runs it (the Pallas ``tc``
kernel in interpret mode on the CPU), at the sizes of its ``SHAPES`` or
smaller; inputs are numpy draws from a seed handed to both packages. On
the CPU the port's wrapper takes its plain version
(``ref.fused_stencil_tc*``), so these tests hold the port's plumbing —
plans, groups, padding, φ sequences, the aux carry, the member axis —
and its rounding to the reference. Tests marked ``cuda`` hold the CUDA
kernel ``csrc/fused_stencil_tc.cu`` to that plain version and skip
without a card.

Tolerances: the reference's own (``tests/test_tc.py:66``), 2e-5 in
float32 and 2e-2 in bfloat16, compared in float32 relative to the
largest |value|; the MHD forms at 1e-5 as the other MHD parity tests
(both packages contract each group in float32 and sum the groups in the
same order; XLA and PyTorch round φ's point-wise arithmetic
independently). On the card the f32 kernel contracts on the f64 MMA, at
most a few f32 roundings from the plain version: 1e-5 there too.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import stencil as js  # noqa: E402
from repro.core.fusion import integrate as jintegrate  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.physics import diffusion as jd  # noqa: E402
from repro.physics import mhd as jm  # noqa: E402
from repro_torch.convert import fields_from_numpy  # noqa: E402
from repro_torch.core.boundary import pad  # noqa: E402
from repro_torch.core import stencil as ts  # noqa: E402
from repro_torch.core.fusion import FusedStencilOp  # noqa: E402
from repro_torch.core.fusion import integrate as tintegrate  # noqa: E402
from repro_torch.kernels import emit, ref  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels.ops import fused_stencil_nd, plan_for_nd  # noqa: E402
from repro_torch.kernels.phi import select_phi  # noqa: E402
from repro_torch.physics import diffusion as td  # noqa: E402
from repro_torch.physics import mhd as tm  # noqa: E402

SHAPES = {1: (1 << 10,), 2: (32, 64), 3: (16, 12, 16)}  # tests/test_tc.py:39
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MHD_TOL = 1e-5
CPU = "cpu"


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --- diffusion: the port against the JAX tc kernel ------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("fuse", (1, 2))
@pytest.mark.parametrize("ndim", (1, 2, 3))
def test_tc_diffusion_matches_jax(ndim, fuse, dtype):
    """``step_op("tc", fuse_steps)`` at every rank and both dtypes equals
    the JAX ``tc`` step, and both stay within the reference's tolerance
    of the float32 ``hwc`` integration."""
    jp = jd.DiffusionProblem(SHAPES[ndim], accuracy=6)
    f32 = jp.init_field(seed=1)
    f0 = jnp.asarray(f32, getattr(jnp, dtype))
    want = jp.step_op("tc", fuse_steps=fuse)(f0)
    tp = td.DiffusionProblem(SHAPES[ndim], accuracy=6)
    got = tp.step_op("tc", fuse_steps=fuse, device=CPU)(
        fields_from_numpy(np.asarray(f0), device=CPU)
    )
    assert got.dtype == getattr(torch, dtype)  # cast back on the store
    assert got.shape == (1,) + SHAPES[ndim]
    assert _rel(_f32(got), _f32(want)) <= TOL[dtype]
    expect = np.asarray(jintegrate(jp.step_op("hwc"), f32, fuse))
    assert _rel(_f32(got), expect) <= TOL[dtype]


def test_tc_simulate_matches_jax_with_a_remainder():
    """5 steps at depth 2 (two depth-2 calls and a depth-1 remainder)."""
    shape = (32, 64)
    f0 = jd.DiffusionProblem(shape).init_field(seed=4)
    want = jd.simulate(jd.DiffusionProblem(shape), f0, 5, strategy="tc",
                       fuse_steps=2)
    got = td.simulate(td.DiffusionProblem(shape), np.asarray(f0), 5,
                      strategy="tc", fuse_steps=2, device=CPU)
    assert _rel(got.numpy(), want) <= TOL["float32"]


@pytest.mark.parametrize("shape,order,n_steps", (
    ((16, 32), 10, 3),  # the reference's tc:o10 (ROADMAP C1's case)
    ((8, 8, 16), 12, 2),
))
def test_tc_beyond_radius_4_matches_jax(shape, order, n_steps):
    """Radius 5 and 6: the band of 8 + 2r rows takes more than one
    k-step on the card; the reference runs both, and so does the port."""
    jp = jd.DiffusionProblem(shape, accuracy=order)
    f0 = jp.init_field(seed=5)
    want = jintegrate(jp.step_op("tc"), f0, n_steps)
    tp = td.DiffusionProblem(shape, accuracy=order)
    op = tp.step_op("tc", device=CPU)
    got = tintegrate(op, torch.from_numpy(np.array(f0)), n_steps)
    assert op.radius_per_axis == (order // 2,) * len(shape)
    assert got.shape == (1,) + shape
    assert _rel(got.numpy(), want) <= TOL["float32"]


@pytest.mark.parametrize("fuse", (1, 2))
def test_tc_batched_matches_jax_per_member(fuse):
    """A B = 3 stack through tc: the JAX batched lowering, and each
    member equal to the port's unbatched step on it."""
    jp = jd.DiffusionProblem((32, 64), accuracy=6)
    stack = np.stack([np.asarray(jp.init_field(seed=s)) for s in range(3)])
    want = jp.step_op("tc", fuse_steps=fuse)(jnp.asarray(stack))
    op = td.DiffusionProblem((32, 64), accuracy=6).step_op(
        "tc", fuse_steps=fuse, device=CPU
    )
    got = op(torch.from_numpy(stack))
    assert got.shape == stack.shape
    assert _rel(got.numpy(), want) <= TOL["float32"]
    for m in range(3):
        assert torch.equal(got[m], op(torch.from_numpy(stack[m])))


# --- MHD: the three forms on tc --------------------------------------------------


@pytest.mark.parametrize("form", ("rhs", "plain", "fuse_rk_axpy",
                                  "fuse_rk_pairs"))
def test_tc_mhd_forms_match_jax(form):
    """``MHDSolver(strategy="tc")`` f32 at (8, 8, 16): the RHS, the plain
    RK3 step, the fused-axpy substeps and ``fuse_rk_pairs``."""
    shape = (8, 8, 16)
    kw = {} if form in ("rhs", "plain") else {form: True}
    jsolver = jm.MHDSolver(shape, strategy="tc", **kw)
    f0 = jsolver.init_smooth(seed=1, amplitude=1e-2, dtype=jnp.float32)
    tsolver = tm.MHDSolver(shape, strategy="tc", device=CPU, **kw)
    tf0 = torch.from_numpy(np.array(f0))
    if form == "rhs":
        want, got = jsolver.rhs(f0), tsolver.rhs(tf0)
    else:
        want, got = jsolver.step(f0, 1e-3), tsolver.step(tf0, 1e-3)
    assert got.shape == (8,) + shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= MHD_TOL


def test_tc_mhd_rhs_equals_swc_within_f32():
    """The tc grouping changes only the rounding: within 1e-5 of swc."""
    shape = (8, 8, 16)
    tc = tm.MHDSolver(shape, strategy="tc", device=CPU)
    swc = tm.MHDSolver(shape, strategy="swc", device=CPU)
    f = tc.init_smooth(seed=2, amplitude=1e-2, dtype=torch.float32)
    assert _rel(tc.rhs(f), swc.rhs(f)) <= MHD_TOL


# --- the groups: the port's copy against the reference's --------------------------


@pytest.mark.parametrize("order", (2, 4, 6, 8))
def test_tc_axis_groups_equal_the_reference(order):
    for ndim in (1, 2, 3):
        sets = [
            (js.derivative_operator_set(ndim, order, 0.3),
             ts.derivative_operator_set(ndim, order, 0.3)),
        ]
        jdp = jd.DiffusionProblem(SHAPES[ndim], accuracy=order)
        tdp = td.DiffusionProblem(SHAPES[ndim], accuracy=order)
        sets.append((jdp.step_op("hwc").ops,
                     tdp.step_op("hwc", device=CPU).ops))
        for jops_, tops in sets:
            for jspec, tspec in zip(jops_.ops, tops.ops):
                assert tplan.tc_axis_groups(tspec, ndim) == (
                    jplan.tc_axis_groups(jspec, ndim)
                )
            assert tplan.tc_groups_per_axis(tops) == (
                jplan.tc_groups_per_axis(jops_)
            )


def test_tc_groups_of_the_main_path_sets():
    """Diffusion: one group per axis; MHD at order 6: 2 groups on z, 8 on
    y, 14 on x per field, and 3 lone taps."""
    for ndim in (1, 2, 3):
        ops = td.DiffusionProblem(SHAPES[ndim]).step_op("hwc", device=CPU).ops
        assert tplan.tc_groups_per_axis(ops) == (1,) * ndim
    mhd = tm.MHDSolver((8, 8, 16), device=CPU).operator_set
    assert tplan.tc_groups_per_axis(mhd) == (2, 8, 14)
    lone = sum(
        len(t) == 1
        for spec in mhd.ops
        for t in tplan.tc_axis_groups(spec, 3).values()
    )
    assert lone == 3


def test_tc_table_lifts_axes_and_lays_out_the_band():
    ops = ts.derivative_operator_set(2, 6, 0.3)
    entries, coeffs, starts, _ = emit.tc_table(ops)
    assert entries.shape[1] == emit.TC_ENT_LEN
    # a row of 2·r_max + 1 coefficients (7 at order 6), any radius
    assert coeffs.shape[1] == emit.tc_coef_len(ops.radius_per_axis()) == 7
    wide = emit.tc_table(ts.derivative_operator_set(2, 12, 0.3))[1]
    assert wide.shape[1] == 13
    assert int(starts[-1]) == entries.shape[0]
    dx = ops.ops[ops.names.index("dx")]
    i = int(starts[ops.names.index("dx")])
    assert entries[i].tolist()[:5] == [2, 0, 0, 0, 0]  # x, no rest, a band
    for off, c in zip(dx.offsets, dx.coeffs):
        assert float(coeffs[i, off[1] + 3]) == c
    # an operator's groups run axis by axis (sorted (axis, rest))
    for o in range(ops.n_s):
        axes = entries[int(starts[o]):int(starts[o + 1]), 0].tolist()
        assert axes == sorted(axes)


def _band(order: int, dtype: str):
    """(band c[j + r] of the x arm of the order-``order`` 1-D second
    derivative rounded to ``dtype``, r)."""
    spec = ts.derivative_operator_set(1, order, 0.3).ops[0]
    r = order // 2
    c = np.zeros(2 * r + 1)
    for off, v in zip(spec.offsets, spec.coeffs):
        c[off[0] + r] = v
    return emit._band_in(list(c), dtype), r


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("order", (2, 4, 6, 8, 10, 12))
def test_tc_fragments_hold_the_band(order, dtype):
    """The words of ``emit.tc_fragments`` rebuilt into the MMA operands by
    the lane layouts of mma.sync (groupID = lane / 4, thread in group =
    lane % 4) equal a numpy band B[k][n] = c[k - n] (x: B, k over the
    window line; y: A = Bᵀ over 16 or 8 outputs), k-step by k-step: one
    k-step of 16 up to r = 4 along x in bf16, two beyond."""
    c, r = _band(order, dtype)

    def band(k, n):
        return c[k - n] if 0 <= k - n <= 2 * r else 0.0

    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for axis in ("x", "y"):
        words = emit.tc_fragments(list(c), dtype, axis)
        steps = tplan.tc_band_ksteps(r, dtype, axis)
        if dtype == "float32":
            assert steps == -(-(8 + 2 * r) // 4)
            vals = words.view(np.float64).reshape(steps, 32)
            for s_ in range(steps):
                for lane in lanes:
                    # B[k=4s+t][n=g] for x; A[m=g][k=4s+t] = c[k - m] for y
                    assert vals[s_, lane] == band(4 * s_ + t[lane], g[lane])
            continue
        per = 2 if axis == "x" else 4
        assert steps == -(-((8 if axis == "x" else 16) + 2 * r) // 16)
        if axis == "x":
            assert steps == (1 if r <= 4 else 2)
        w = words.reshape(steps, 32, per)
        lo = torch.from_numpy((w & 0xFFFF).astype(np.int16)).view(
            torch.bfloat16).float().numpy()
        hi = torch.from_numpy((w >> 16).astype(np.int16)).view(
            torch.bfloat16).float().numpy()
        for s_ in range(steps):
            for lane in lanes:
                k = 16 * s_ + 2 * t[lane]
                if axis == "x":  # b0 = B[k, k+1][g], b1 = B[k+8, k+9][g]
                    want = [(band(k, g[lane]), band(k + 1, g[lane])),
                            (band(k + 8, g[lane]), band(k + 9, g[lane]))]
                else:  # A[m][k] = c[k - m]: rows g, g + 8; cols k, k + 8
                    want = [(band(k + i0, g[lane] + m),
                             band(k + i0 + 1, g[lane] + m))
                            for m, i0 in ((0, 0), (8, 0), (0, 8), (8, 8))]
                got = [(lo[s_, lane, j], hi[s_, lane, j]) for j in range(per)]
                assert got == want


def test_tc_table_runs_follow_the_reference_order():
    """Each operator's groups form one run per axis (z, y, x), in the
    reference's sorted (axis, rest) order; the depth-1 table holds the
    starts and the rows, then every group's own data in group order,
    16-byte aligned: a lone tap's and a z arm's coefficients rounded to
    the field dtype, a y or x contraction's fragments."""
    for ndim, order in ((1, 6), (2, 8), (3, 6)):
        ops = ts.derivative_operator_set(ndim, order, 0.3)
        for dtype in ("float32", "bfloat16"):
            entries, coeffs, starts, table = emit.tc_table(ops, dtype)
            lift = 3 - ndim
            radii = (0,) * lift + ops.radius_per_axis()
            n = len(starts)
            head = -(-n // 4) * 4
            assert table[:n].tolist() == starts.tolist()
            assert table[head:head + entries.numel()].tolist() == (
                entries.reshape(-1).tolist())
            offset = tplan.tc_table_header_words(ops)
            assert offset == head + entries.numel()
            for o, spec in enumerate(ops.ops):
                first = int(starts[o])
                rows = entries[first:int(starts[o + 1])].tolist()
                keys = sorted(tplan.tc_axis_groups(spec, ndim).items())
                assert [r[0] for r in rows] == sorted(r[0] for r in rows)
                assert len(rows) == len(keys)
                for e, (row, ((axis, rest), taps)) in enumerate(
                        zip(rows, keys), first):
                    assert row[0] == axis + lift
                    assert tuple(row[1 + lift:4]) == rest
                    assert row[6] == offset and row[6] % 4 == 0
                    r = radii[row[0]]
                    words = tplan.tc_group_words(len(taps), row[0], r, dtype)
                    if len(taps) == 1 or row[0] == 0:  # coefficients in T
                        want = [taps[0][1]] if len(taps) == 1 else (
                            coeffs[e, :2 * r + 1].tolist())
                        got = table[offset:offset + words].numpy().view(
                            np.float64)[:len(want)]
                        assert np.array_equal(got, emit._band_in(want, dtype))
                    offset += words
            assert table.numel() == offset == tplan.tc_table_words(ops, dtype)


@pytest.mark.parametrize("shape,block,batch,grid", (
    ((48, 40), (16, 8), 3, 7),        # 45 steps on 7 blocks
    ((8, 12, 40), (4, 4, 8), 2, 13),  # 90 steps on 13 blocks
    ((6144,), (512,), 5, 4),          # rank 1: 4 tiles a step, 15 steps
))
def test_tc_persistent_walk_covers_every_tile_once(shape, block, batch, grid):
    """The mirror of the depth-1 kernel's walk: block b takes steps b, b +
    grid, ...; together the blocks cover every (member, z, y, x) tile once
    even when the steps are no multiple of the grid."""
    ops = ts.derivative_operator_set(len(shape), 2, 0.3)
    padded = (batch, 1) + tuple(n + 2 for n in shape)
    plan = tplan.plan_stencil(ops, padded, 1, strategy="tc", block=block)
    assert plan.block == block and plan.walk_items % grid
    walks = tplan.persistent_walk(plan, grid)
    tz, ty, tx = tplan._lift3(block, 1)
    seen = []
    for steps in walks:
        for member, z0, y0, x0 in steps:
            for i in range(plan.tiles_per_step):
                seen.append((member, z0, y0, x0 + i * tx))
    nz, ny, nx = (n // t for n, t in zip(tplan._lift3(shape, 1), (tz, ty, tx)))
    want = [(m, iz * tz, iy * ty, ix * tx) for m in range(batch)
            for iz in range(nz) for iy in range(ny) for ix in range(nx)]
    assert sorted(seen) == want
    assert len(seen) == len(set(seen))
    assert max(map(len, walks)) - min(map(len, walks)) == 1


def test_mhd_tc_tile_is_the_planners():
    """MHDSolver leaves the depth-1 tc kernel's tile to its planner
    (TC_MHD_BLOCK: 8 rows along y and 16 along x for the MMA patches, 4
    planes, 512 points); the pair at depth 2 keeps ``block``."""
    solver = tm.MHDSolver((16, 16, 32), strategy="tc", device=CPU)
    assert solver.rhs_op().block is None
    assert solver._fused_substep_op(0.0, 1.0, 1e-3).block is None
    pair = tm.MHDSolver((16, 16, 32), strategy="tc", fuse_rk_pairs=True,
                        device=CPU)
    assert pair._fused_pair_op(1e-3).block == pair.block == (1, 8, 32)
    assert tm.MHDSolver((16, 16, 32), device=CPU).rhs_op().block == (
        1, 8, 32)  # swc keeps the solver's block
    plan = plan_for_nd(solver.operator_set, (8, 22, 22, 38), 8,
                       strategy="tc", max_threads=256, n_slots=10)
    assert plan.block == tplan.TC_MHD_BLOCK == (4, 8, 16)
    assert tplan.tc_step(plan.block, plan.radii, 1, "float32").points == (
        plan.threads)
    # no z contraction issues 8 outputs for 1: the z arm runs on FMAs,
    # and every patch is full (8 rows of y, 8 columns of x)
    issued, needed = tplan.tc_issued_macs(plan, solver.operator_set,
                                          list(solver.operator_set.names))
    assert issued / needed < 2.6


# --- plan rules ---------------------------------------------------------------------


def test_tc_plan_rules_follow_the_reference():
    ops = ts.derivative_operator_set(2, 6)
    shape = (1, 38, 70)
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        tplan.plan_stencil(ops, shape, 1, strategy="tc", dtype="float64")
    with pytest.raises(ValueError, match="unroll"):
        tplan.plan_stencil(ops, shape, 1, strategy="tc", unroll=2)
    with pytest.raises(ValueError, match="aux"):
        tplan.plan_stencil(ops, (3, 1, 44, 76), 2, strategy="tc", n_aux=1,
                           fuse_steps=2)
    # radius 5 (order 10) is planned, as the reference plans tc:o10
    o10 = tplan.plan_stencil(ts.derivative_operator_set(2, 10), (1, 42, 74),
                             1, strategy="tc")
    j10 = jplan.plan_stencil(js.derivative_operator_set(2, 10), (1, 42, 74),
                             1, strategy="tc")
    assert o10.radii == j10.radii == (5, 5)
    assert j10.strategy_id == "tc:o10"
    assert o10.smem_bytes <= tplan.SMEM_PER_BLOCK
    # the reference agrees on the first three
    jops_ = js.derivative_operator_set(2, 6)
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        jplan.plan_stencil(jops_, shape, 1, strategy="tc", dtype="float64")
    for dtype in ("float32", "bfloat16"):
        for depth in (1, 2):
            p = tplan.plan_stencil(
                ops, (1,) + tuple(n + 6 * (depth - 1) for n in shape[1:]), 1,
                strategy="tc", dtype=dtype, fuse_steps=depth,
            )
            assert p.threads % 32 == 0 and p.threads <= 1024
            assert p.smem_bytes <= tplan.SMEM_PER_BLOCK
            assert emit.kernel_name(p) == "fused_stencil_tc"


def test_tc_threads_and_smem_are_the_kernel_layout():
    """Counted by hand from csrc/tc_body.cuh's layout (depth 1: a ring of
    window buffers, rows of a 16-byte multiple holding the window plus 3
    (f32) or 7 (bf16) elements of shift, the band's fragments, the MHD
    sums) and, at depth 2, csrc/temporal_body.cuh's and
    csrc/fused_stencil_tc.cu's sum tiles."""
    diff = td.DiffusionProblem((512,) * 3).step_op("hwc", device=CPU).ops
    p = tplan.plan_stencil(diff, (1, 518, 518, 518), 1, strategy="tc")
    assert p.block == (8, 8, 32) and p.threads == 256
    # window 14 x 14 x 38; rows padded to the y MMA's k (8 + 16 - 8 = 16)
    # and to 40 columns (the x MMA's k), pitch 44 (40 + 3, 16 bytes)
    assert p.tc_step.rows_padded == 16 and p.tc_step.pitch == 44
    assert p.stage_buffers == 2  # three would leave one block per SM
    # the table: 2 starts (4 words) and 3 group rows, the z arm's 7
    # doubles (16 words), the y and x groups' fragments: 4 k-steps, 32
    # lanes, 1 double
    table = 4 + 24 + 16 + 2 * 4 * 32 * 2
    assert p.tc_table_words == table
    assert p.smem_bytes == 2 * 14 * 16 * 44 * 4 + 4 * table
    bf = tplan.plan_stencil(diff, (1, 518, 518, 518), 1, strategy="tc",
                            dtype="bfloat16")
    assert bf.block == (4, 16, 32) and bf.stage_buffers == 3
    # y: 2 k-steps of 16 x 4 words; x: 1 of 16 x 2 words
    assert bf.tc_table_words == 4 + 24 + 16 + 2 * 32 * 4 + 32 * 2
    assert bf.smem_bytes == 3 * 10 * 32 * 48 * 2 + 4 * bf.tc_table_words
    ops = tm.MHDSolver((256,) * 3, device=CPU).operator_set
    rhs = plan_for_nd(ops, (8, 262, 262, 262), 8, strategy="tc",
                      max_threads=256, n_slots=10)
    assert rhs.block == (4, 8, 16) and rhs.threads == 512
    assert rhs.stage_buffers == 2
    # 11 starts (12 words) and 27 group rows, 3 lone taps (4 words
    # each), 2 z arms (16), 22 y/x groups of 4 f64 k-steps; sums of 10
    # slots x 8 fields x 512 points
    assert rhs.tc_table_words == (12 + 27 * 8 + 3 * 4 + 2 * 16
                                  + 22 * 4 * 32 * 2)
    assert rhs.smem_bytes == (2 * 10 * 16 * 28 * 4 + 4 * rhs.tc_table_words
                              + 10 * 8 * 512 * 4)
    pair = plan_for_nd(ops, (8, 140, 140, 140), 16,
                       aux_shape=(8, 134, 134, 134), strategy="tc",
                       block=(1, 8, 32), fuse_steps=2, max_threads=256,
                       n_slots=10)
    assert pair.smem_bytes <= tplan.SMEM_PER_BLOCK and pair.threads == 256
    r0 = (1 + 6) * (pair.block[1] + 6) * (pair.block[2] + 6)
    plane = (pair.block[1] + 6) * (pair.block[2] + 6)
    assert tplan.tc_acc_points(pair.block, pair.radii, 2, 10,
                               pair.threads) == min(r0, 256 + 2 * plane)


def test_tc_issued_macs_count_the_band():
    """Diffusion 512³ order 6 at (8, 8, 32), depth 1: 32 patches of 8 × 8
    outputs per tile; per patch the y and x contractions issue 8 × 8 × 16
    (k = 4·ceil(14 / 4)) on the f64 MMA and the z arm its 6 taps × 64
    FMAs; bf16 at (4, 16, 32): 16 patches of 16 × 8, y 16 × 8 × 32
    (16 + 6 rows in two k-steps), x 16 × 8 × 16; against the taps' 19 per
    point."""
    diff = td.DiffusionProblem((512,) * 3).step_op("hwc", device=CPU).ops
    z_taps = 6  # the center tap is x's
    for dtype, patches, rows, ky, kx in (("float32", 32, 8, 16, 16),
                                         ("bfloat16", 16, 16, 32, 16)):
        p = tplan.plan_stencil(diff, (1, 518, 518, 518), 1, strategy="tc",
                               dtype=dtype)
        issued, needed = tplan.tc_issued_macs(p, diff, ["step"])
        steps = 512 ** 3 // tplan._prod(p.block)
        per_patch = rows * 8 * (ky + kx + z_taps)
        assert p.tc_step.patches == patches
        assert issued == per_patch * patches * steps
        assert needed == 19 * 512 ** 3
    # Order 10 at rank 1, tile 512, 8 tiles a step: 64 patches of 8
    # segments (f32) or 32 of 16 (bf16), a band of 18 rows: f32 k =
    # 4·ceil(18 / 4) = 20, bf16 two k-steps of 16 (k = 32).
    o10 = td.DiffusionProblem((4096,), accuracy=10).step_op(
        "hwc", device=CPU).ops
    for dtype, rows, k in (("bfloat16", 16, 32), ("float32", 8, 20)):
        p = tplan.plan_stencil(o10, (1, 4106), 1, strategy="tc", dtype=dtype)
        issued, needed = tplan.tc_issued_macs(p, o10, ["step"])
        assert p.block == (512,) and p.tiles_per_step == 8
        assert issued == 4096 // (rows * 8) * rows * 8 * k
        assert needed == 11 * 4096
    # Depth 2 keeps the temporal evaluator's count: the regions, 8
    # row-segments a tile, the band in k-steps of 4.
    p2 = tplan.plan_stencil(diff, (1, 524, 524, 524), 1, strategy="tc",
                            fuse_steps=2)
    issued, _ = tplan.tc_issued_macs(p2, diff, ["step"])
    assert issued > 0 and not p2.tc_depth1


# --- what waits for a ROADMAP item -------------------------------------------------


def test_bf16_without_a_kernel_names_its_roadmap_item():
    ops = ts.derivative_operator_set(3, 6)
    with pytest.raises(NotImplementedError, match="B2c"):
        tplan.plan_stencil(ops, (1, 28, 28, 44), 1, dtype="bfloat16",
                           fuse_steps=2)
    with pytest.raises(NotImplementedError, match="B3c"):
        tplan.plan_stencil(ops, (1, 22, 22, 38), 1, dtype="bfloat16",
                           strategy="swc_stream")
    solver = tm.MHDSolver((8, 8, 16), strategy="tc", device=CPU)
    with pytest.raises(NotImplementedError, match="B4b"):
        solver.rhs(solver.init_fields(dtype=torch.bfloat16))
    # the plain regime takes bf16 MHD, as the reference does
    hwc = tm.MHDSolver((8, 8, 16), strategy="hwc", device=CPU)
    assert hwc.rhs(hwc.init_fields(dtype=torch.bfloat16)).dtype == (
        torch.bfloat16
    )


# --- B1b: bf16 on swc at depth 1 ------------------------------------------------------


@pytest.mark.parametrize("ndim", (1, 2, 3))
def test_swc_bf16_depth1_matches_jax(ndim):
    """The swc plain version in bf16 (coefficient cast per tap, every
    product and sum rounded to bf16) against the JAX swc kernel in
    bf16, compared in f32 at the reference's bf16 tolerance."""
    rng = np.random.default_rng(ndim)
    shape = (2,) + tuple(n + 4 for n in SHAPES[ndim])
    fp = rng.standard_normal(shape).astype(np.float32)
    fb = jnp.asarray(fp, jnp.bfloat16)
    want = jops.fused_stencil_nd(
        fb, js.derivative_operator_set(ndim, 4, 0.3), lambda d: d["dxx"], 2,
        strategy="swc", interpret=True,
    )
    got = fused_stencil_nd(
        fields_from_numpy(np.asarray(fb), device=CPU),
        ts.derivative_operator_set(ndim, 4, 0.3), select_phi("dxx"), 2,
        strategy="swc",
    )
    assert got.dtype == torch.bfloat16
    assert _rel(_f32(got), _f32(want)) <= TOL["bfloat16"]


def test_bf16_crosses_from_jax_exactly():
    a = jnp.asarray(np.linspace(-3.0, 3.0, 97), jnp.bfloat16)
    t = fields_from_numpy(np.asarray(a), device=CPU)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(a, np.float32))


def test_tc_cpu_path_counts_no_launch():
    ops = ts.derivative_operator_set(1, 2)
    emit.reset_launch_counts()
    out = fused_stencil_nd(torch.ones(1, 34), ops, select_phi("val"), 1,
                           strategy="tc")
    assert out.shape == (1, 32)
    assert emit.fused_stencil_swc.launches == 0


def test_tc_refuses_a_bare_callable():
    ops = ts.derivative_operator_set(1, 2)
    with pytest.raises(ValueError, match="strategy='hwc'"):
        FusedStencilOp(ops, lambda d: d["val"], 1, strategy="tc")


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


CARD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("fuse", (1, 2))
@pytest.mark.parametrize("ndim", (1, 2, 3))
def test_tc_kernel_matches_plain_on_card(cuda_device, ndim, fuse, dtype):
    p = td.DiffusionProblem(SHAPES[ndim], accuracy=6)
    op = p.step_op("tc", fuse_steps=fuse, device=cuda_device)
    f = p.init_field(seed=3, device=cuda_device, dtype=dtype)
    emit.reset_launch_counts()
    got = op(f)
    assert emit.fused_stencil_swc.launches_by_kernel == {
        "fused_stencil_tc": 1
    }
    padded = pad(f, [r * fuse for r in op.radius_per_axis], "periodic",
                 spatial_axes=range(1, f.ndim))
    want = ref.fused_stencil_tc_steps(padded, op.ops, op.phi.torch_fn, fuse)
    assert got.dtype == f.dtype
    assert _rel(_f32(got.cpu()), _f32(want.cpu())) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape,order", (((64, 96), 10), ((16, 24, 40), 12),
                                         ((30030,), 12)))
def test_tc_kernel_beyond_radius_4_matches_plain_on_card(cuda_device, shape,
                                                          order, dtype):
    p = td.DiffusionProblem(shape, accuracy=order)
    op = p.step_op("tc", device=cuda_device)
    f = p.init_field(seed=3, device=cuda_device, dtype=dtype)
    emit.reset_launch_counts()
    got = op(f)
    assert emit.fused_stencil_swc.launches_by_kernel == {
        "fused_stencil_tc": 1
    }
    padded = pad(f, op.radius_per_axis, "periodic",
                 spatial_axes=range(1, f.ndim))
    want = ref.fused_stencil_tc(padded, op.ops, op.phi.torch_fn)
    assert _rel(_f32(got.cpu()), _f32(want.cpu())) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ("plain", "fuse_rk_axpy", "fuse_rk_pairs"))
def test_tc_mhd_kernel_matches_plain_on_card(cuda_device, form):
    shape = (16, 16, 32)
    kw = {} if form == "plain" else {form: True}
    card = tm.MHDSolver(shape, strategy="tc", device=cuda_device, **kw)
    cpu = tm.MHDSolver(shape, strategy="tc", device=CPU, **kw)
    f = cpu.init_smooth(seed=1, amplitude=1e-2, dtype=torch.float32)
    got = card.step(f.to(cuda_device), 1e-3)
    assert _rel(got.cpu().numpy(), cpu.step(f, 1e-3).numpy()) <= MHD_TOL


def _launch_vs_plain(fp, ops, phi, plan, aux=None):
    """(kernel output, plain output) of one launch of ``plan``."""
    got = emit.fused_stencil_swc(fp, ops, phi, plan, aux=aux)
    fn = ref.fused_stencil_tc_batched if fp.ndim == plan.rank + 2 else (
        ref.fused_stencil_tc)
    return got, fn(fp, ops, phi.torch_fn, aux=aux)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape,block,order", (
    ((30030,), None, 6),          # 2002-point tiles: a ragged last segment
    ((50, 70), (10, 14), 6),      # y and x tiles off 8 and 16
    ((9, 22, 30), (3, 11, 15), 6),
    ((6, 20, 36), None, 10),
    ((40, 56), None, 12),
))
def test_tc_depth1_ragged_tiles_match_plain_on_card(cuda_device, shape,
                                                    block, order, dtype):
    """The persistent depth-1 kernel on extents and tiles that are no
    multiple of 8, 16 or the default tile, at orders 6, 10 and 12."""
    ops = ts.derivative_operator_set(len(shape), order, 0.3)
    r = order // 2
    g = torch.Generator().manual_seed(7)
    fp = torch.rand((2,) + tuple(n + 2 * r for n in shape), generator=g,
                    dtype=torch.float64).to(cuda_device, getattr(torch, dtype))
    plan = plan_for_nd(ops, tuple(fp.shape), 2, strategy="tc", block=block,
                       dtype=dtype)
    assert plan.tc_depth1 and emit.kernel_smem_bytes(plan) == plan.smem_bytes
    got, want = _launch_vs_plain(fp, ops, select_phi("dxx"), plan)
    assert _rel(_f32(got.cpu()), _f32(want.cpu())) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", ((48, 64, 120), (40, 1000), (1000, 1000)))
def test_tc_depth1_grid_walks_every_step_on_card(cuda_device, shape,
                                                 dtype):
    """The persistent grid against the steps it walks: fewer steps than
    blocks the card can hold (idle blocks), and more steps than blocks,
    no multiple of them (blocks taking one step more than others)."""
    p = td.DiffusionProblem(shape, accuracy=6)
    op = p.step_op("tc", device=cuda_device)
    f = p.init_field(seed=3, device=cuda_device, dtype=dtype)
    fp = pad(f, op.radius_per_axis, "periodic",
             spatial_axes=range(1, f.ndim))
    plan = plan_for_nd(op.ops, tuple(fp.shape), 1, strategy="tc", dtype=dtype)
    grid = emit.launch_grid(plan, op.phi.kind_id, cuda_device.index or 0)
    assert 1 <= grid <= plan.walk_items
    got = emit.fused_stencil_swc(fp, op.ops, op.phi, plan)
    plain = ref.fused_stencil_tc(fp, op.ops, op.phi.torch_fn)
    assert _rel(_f32(got.cpu()), _f32(plain.cpu())) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("diffusion f32", "diffusion bf16",
                                  "mhd_rhs", "mhd_substep"))
def test_tc_depth1_members_equal_their_launch_on_card(cuda_device, case):
    """B = 3 members in one launch: each equal to its unbatched launch
    bit for bit, and the stack within tolerance of the batched plain
    version."""
    import dataclasses

    if case.startswith("diffusion"):
        dtype = "float32" if case.endswith("f32") else "bfloat16"
        ops = ts.derivative_operator_set(3, 6, 0.3)
        g = torch.Generator().manual_seed(11)
        fp = torch.rand((3, 1, 22, 28, 46), generator=g,
                        dtype=torch.float64).to(cuda_device,
                                                getattr(torch, dtype))
        phi, aux, tol = select_phi("dxx"), None, CARD_TOL[dtype]
        plan = plan_for_nd(ops, tuple(fp.shape), 1, strategy="tc",
                           dtype=dtype)
    else:
        solver = tm.MHDSolver((12, 24, 48), strategy="tc",
                              device=cuda_device)
        ops = solver.operator_set
        f = torch.stack([solver.init_smooth(seed=s, amplitude=1e-2,
                                            dtype=torch.float32)
                         for s in range(3)])
        fp = pad(f, 3, "periodic", spatial_axes=(2, 3, 4))
        if case == "mhd_rhs":
            phi, aux = tm.mhd_rhs_device_phi(solver.params), None
        else:
            phi = tm.mhd_substep_device_phi(solver.params, tm.RK3_ALPHA[1],
                                            tm.RK3_BETA[1], 1e-3)
            aux = 1e-3 * torch.rand_like(f)
        tol = MHD_TOL
        plan = plan_for_nd(ops, tuple(fp.shape), phi.n_out(8),
                           aux_shape=None if aux is None else tuple(aux.shape),
                           strategy="tc", max_threads=phi.max_threads,
                           n_slots=len(phi.operators))
    assert plan.batch == 3 and plan.tc_depth1
    got, want = _launch_vs_plain(fp, ops, phi, plan, aux)
    assert _rel(_f32(got.cpu()), _f32(want.cpu())) <= tol
    solo = dataclasses.replace(plan, batch=1)
    for m in range(3):
        one = emit.fused_stencil_swc(fp[m], ops, phi, solo,
                                     aux=None if aux is None else aux[m])
        assert torch.equal(got[m], one)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ("rhs", "plain", "fuse_rk_axpy",
                                  "fuse_rk_pairs"))
def test_tc_depth1_mhd_forms_match_plain_on_card(cuda_device, form):
    """The three RK3 forms and the RHS on a non-cubic box whose z extent
    is no multiple of the tile's 4 planes' default (12 = 3 tiles), with
    the solver's own tc tile."""
    shape = (12, 24, 48)
    kw = {} if form in ("rhs", "plain") else {form: True}
    card = tm.MHDSolver(shape, strategy="tc", device=cuda_device, **kw)
    cpu = tm.MHDSolver(shape, strategy="tc", device=CPU, **kw)
    f = cpu.init_smooth(seed=4, amplitude=1e-2, dtype=torch.float32)
    emit.reset_launch_counts()
    if form == "rhs":
        got, want = card.rhs(f.to(cuda_device)), cpu.rhs(f)
    else:
        got, want = card.step(f.to(cuda_device), 1e-3), cpu.step(f, 1e-3)
    assert set(emit.fused_stencil_swc.launches_by_kernel) == {
        "fused_stencil_tc"}
    assert _rel(got.cpu().numpy(), want.numpy()) <= MHD_TOL
