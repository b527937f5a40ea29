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
    entries, coeffs, starts = emit.tc_table(ops)
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
    """Counted by hand from csrc/temporal_body.cuh's layout and
    csrc/fused_stencil_tc.cu's sum tiles."""
    diff = td.DiffusionProblem((512,) * 3).step_op("hwc", device=CPU).ops
    p = tplan.plan_stencil(diff, (1, 518, 518, 518), 1, strategy="tc")
    assert p.block == (8, 8, 32) and p.threads == 1024
    assert p.stage_buffers == 1  # one field, no next window to overlap
    window = 14 * 14 * 38 * 4
    assert p.smem_bytes == window + 8 * 8 * 32 * 4
    bf = tplan.plan_stencil(diff, (1, 518, 518, 518), 1, strategy="tc",
                            dtype="bfloat16")
    assert bf.smem_bytes == 14 * 14 * 38 * 2 + 8 * 8 * 32 * 4
    mhd = tm.MHDSolver((256,) * 3, device=CPU).operator_set
    rhs = plan_for_nd(mhd, (8, 262, 262, 262), 8, strategy="tc",
                      block=(1, 8, 32), max_threads=256, n_slots=10)
    assert rhs.threads == 256 and rhs.stage_buffers == 2
    assert rhs.smem_bytes == 2 * (7 * 14 * 38 * 4) + 10 * 256 * 4
    pair = plan_for_nd(mhd, (8, 140, 140, 140), 16,
                       aux_shape=(8, 134, 134, 134), strategy="tc",
                       block=(1, 8, 32), fuse_steps=2, max_threads=256,
                       n_slots=10)
    assert pair.smem_bytes <= tplan.SMEM_PER_BLOCK
    r0 = (1 + 6) * (pair.block[1] + 6) * (pair.block[2] + 6)
    plane = (pair.block[1] + 6) * (pair.block[2] + 6)
    assert tplan.tc_acc_points(pair.block, pair.radii, 2, 10,
                               pair.threads) == min(r0, 256 + 2 * plane)


def test_tc_issued_macs_count_the_band():
    """Diffusion 512³ order 6 at (8, 8, 32): per block and axis 256
    row-segments of 8 outputs; f32 issues 8 × 8 × 16 per 8 row-segments
    (k = 4·ceil(14 / 4)), bf16 16 × 8 × 16 per 16: 2048 × 8 × 8 per
    field-axis-block either way, against the taps' 7 + 6 + 6 per point."""
    diff = td.DiffusionProblem((512,) * 3).step_op("hwc", device=CPU).ops
    for dtype in ("float32", "bfloat16"):
        p = tplan.plan_stencil(diff, (1, 518, 518, 518), 1, strategy="tc",
                               dtype=dtype)
        issued, needed = tplan.tc_issued_macs(p, diff, ["step"])
        blocks = 512 ** 3 // 2048
        assert issued == 3 * 256 // 8 * 8 * 8 * 16 * blocks
        assert needed == 19 * 512 ** 3
    # Order 10 at rank 1, tile 512: 64 row-segments, a band of 18 rows:
    # bf16 two k-steps of 16 (k = 32), f32 k = 4·ceil(18 / 4) = 20.
    o10 = td.DiffusionProblem((4096,), accuracy=10).step_op(
        "hwc", device=CPU).ops
    for dtype, rows, k in (("bfloat16", 16, 32), ("float32", 8, 20)):
        p = tplan.plan_stencil(o10, (1, 4106), 1, strategy="tc", dtype=dtype)
        issued, needed = tplan.tc_issued_macs(p, o10, ["step"])
        assert p.block == (512,)
        assert issued == 64 // rows * rows * 8 * k * 8
        assert needed == 11 * 4096


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
