"""Temporal fusion in the port (``fuse_steps > 1`` on ``swc``, MHD
``fuse_rk_pairs``) against the JAX package, plus the depth-S plan rules,
the per-sweep φ sequence, the launch counts and the trafficmodel copy.

The JAX side runs as ``tests/test_temporal.py`` runs it: the Pallas
temporal kernel in interpret mode. On the CPU the port's wrapper takes
its plain version (``ref.fused_stencil_steps``), so these tests hold the
port's plumbing — padding, plans, φ sequences, the aux carry — and its
plain arithmetic to the reference. Tests marked ``cuda`` hold the
temporal CUDA kernel itself to that plain version and skip without a
card.

Tolerances: f64 1e-12 and f32 1e-5 relative to the largest |value|, as
in the depth-1 parity tests (the two packages sum the same taps in the
same order; XLA and PyTorch round φ's point-wise arithmetic
independently, and the CUDA kernel contracts multiply-adds into FMA).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import stencil as js  # noqa: E402
from repro.core import trafficmodel as jtm  # noqa: E402
from repro.core.fusion import integrate as jintegrate  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.physics import diffusion as jd  # noqa: E402
from repro.physics import mhd as jm  # noqa: E402
from repro_torch.core import stencil as ts  # noqa: E402
from repro_torch.core import trafficmodel as ttm  # noqa: E402
from repro_torch.core.boundary import pad  # noqa: E402
from repro_torch.core.fusion import integrate as tintegrate  # noqa: E402
from repro_torch.kernels import emit, ref  # noqa: E402
from repro_torch.kernels.ops import fused_stencil_nd, plan_for_nd  # noqa: E402
from repro_torch.kernels.phi import phi_sequence, select_phi  # noqa: E402
from repro_torch.kernels.plan import (  # noqa: E402
    SMEM_PER_BLOCK,
    StencilPlan,
    plan_stencil,
)
from repro_torch.physics import diffusion as td  # noqa: E402
from repro_torch.physics import mhd as tm  # noqa: E402

TOL = {"float32": 1e-5, "float64": 1e-12}
# The interiors of tests/test_temporal.py: small, not block-aligned.
SHAPES = {1: (60,), 2: (12, 24), 3: (6, 10, 24)}
CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _padded(rank, n_f, depth, dtype, r=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n_f,) + tuple(n + 2 * r * depth for n in SHAPES[rank])
    return rng.standard_normal(shape).astype(dtype)


def _pair_inputs(shape, dtype, seed=3):
    """Fields padded by 2r, the carry w padded by r (radius 3)."""
    rng = np.random.default_rng(seed)
    f = (1e-2 * rng.standard_normal((8,) + shape)).astype(dtype)
    w = (1e-3 * rng.standard_normal((8,) + shape)).astype(dtype)
    wrap = lambda a, h: np.pad(a, ((0, 0),) + ((h, h),) * 3, mode="wrap")  # noqa: E731
    return wrap(f, 6), wrap(w, 3)


# --- the port against JAX ------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("rank", (1, 2, 3))
@pytest.mark.parametrize("fuse_steps", (1, 2, 3))
def test_swc_depth_matches_jax(fuse_steps, rank, dtype):
    """Two fields, the whole derivative set, φ selects one operator,
    S sweeps per call."""
    fp = _padded(rank, 2, fuse_steps, dtype)
    out_t = fused_stencil_nd(
        torch.from_numpy(fp), ts.derivative_operator_set(rank, 4, 0.3),
        select_phi("dxx"), 2, strategy="swc", fuse_steps=fuse_steps,
    )
    out_j = jops.fused_stencil_nd(
        jnp.asarray(fp), js.derivative_operator_set(rank, 4, 0.3),
        lambda d: d["dxx"], 2, strategy="swc", fuse_steps=fuse_steps,
        interpret=True,
    )
    assert out_t.shape == (2,) + SHAPES[rank]
    assert out_t.dtype == getattr(torch, dtype)
    assert _rel(out_t.numpy(), out_j) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_depth2_mhd_substeps_with_aux_carry_match_jax(dtype):
    """Depth 2 with the w carry and two DIFFERENT φs (RK3 substeps 1
    and 2, other α and β): the fused-RK-pair launch."""
    shape = (8, 8, 16)
    fp, wp = _pair_inputs(shape, dtype)
    dt = 0.01
    ab = list(zip(jm.RK3_ALPHA[:2], jm.RK3_BETA[:2]))
    jsolver = jm.MHDSolver(shape)
    out_j = jops.fused_stencil_nd(
        jnp.asarray(fp), js.derivative_operator_set(3, 6, (0.3, 0.2, 0.1)),
        tuple(jsolver._substep_phi(a, b, dt) for a, b in ab), 16,
        aux=jnp.asarray(wp), strategy="swc", fuse_steps=2, interpret=True,
    )
    phis = tuple(
        tm.mhd_substep_device_phi(tm.MHDParams(), a, b, dt) for a, b in ab
    )
    out_t = fused_stencil_nd(
        torch.from_numpy(fp), ts.derivative_operator_set(3, 6, (0.3, 0.2, 0.1)),
        phis, 16, aux=torch.from_numpy(wp), strategy="swc", fuse_steps=2,
    )
    assert out_t.shape == (16,) + shape
    assert _rel(out_t.numpy(), out_j) <= TOL[dtype]


def test_simulate_fuse3_with_remainder_matches_jax():
    """7 steps at depth 3: two depth-3 calls and a depth-1 remainder."""
    shape = (16, 32)
    f0 = jd.DiffusionProblem(shape).init_field(seed=3)  # float32
    want = jd.simulate(jd.DiffusionProblem(shape), f0, 7, strategy="swc",
                       fuse_steps=3)
    got = td.simulate(td.DiffusionProblem(shape), np.asarray(f0), 7,
                      strategy="swc", fuse_steps=3, device=CPU)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_mhd_fuse_rk_pairs_step_matches_jax(dtype):
    shape = (8, 8, 16)
    jsolver = jm.MHDSolver(shape, strategy="swc", fuse_rk_pairs=True)
    f0 = jsolver.init_smooth(seed=1, amplitude=1e-2,
                             dtype=getattr(jnp, dtype))
    want = jsolver.step(f0, 1e-3)
    tsolver = tm.MHDSolver(shape, strategy="swc", fuse_rk_pairs=True,
                           device=CPU)
    got = tsolver.step(torch.from_numpy(np.array(f0)), 1e-3)
    assert got.shape == (8,) + shape
    assert _rel(got.numpy(), want) <= TOL[dtype]


def test_fuse_rk_pairs_equals_three_substeps():
    """The pair launch + one substep is the fused-axpy RK3 step."""
    shape = (8, 8, 16)
    pairs = tm.MHDSolver(shape, strategy="swc", fuse_rk_pairs=True,
                         device=CPU)
    axpy = tm.MHDSolver(shape, strategy="swc", fuse_rk_axpy=True,
                        device=CPU)
    f = pairs.init_smooth(2, amplitude=1e-2)
    assert _rel(pairs.step(f, 1e-3), axpy.step(f, 1e-3)) <= TOL["float64"]


# --- plan rules at depth S ----------------------------------------------------


@pytest.mark.parametrize("fuse_steps", (1, 2, 3))
def test_plan_halo_interior_and_windows(fuse_steps):
    ops = ts.derivative_operator_set(3, 6)  # radius 3
    S = fuse_steps
    plan = plan_stencil(ops, (1, 64 + 6 * S, 32 + 6 * S, 96 + 6 * S), 1,
                        fuse_steps=S)
    assert plan.interior == (64, 32, 96)
    assert plan.halo == (3 * S,) * 3
    assert plan.window == tuple(t + 6 * S for t in plan.block)
    assert plan.aux_window is None
    carried = plan_stencil(ops, (1, 64 + 6 * S, 32 + 6 * S, 96 + 6 * S), 2,
                           n_aux=1, fuse_steps=S, max_threads=256)
    assert carried.aux_window == tuple(
        t + 6 * (S - 1) for t in carried.block
    )


def test_plan_rejects_non_self_map_and_unroll():
    ops = ts.derivative_operator_set(2, 4)
    with pytest.raises(ValueError, match="self-map"):
        plan_stencil(ops, (2, 20, 32), 3, fuse_steps=2)
    with pytest.raises(ValueError, match="unroll"):
        plan_stencil(ops, (1, 20, 40), 1, fuse_steps=2, unroll=2)
    # No depth is fixed in the kernels: depth 9 is planned (ROADMAP C2),
    # and only a depth below 1 is refused.
    deep = StencilPlan(2, "swc", (4, 8), (2, 2), (12, 24), 1, 1, "float32",
                       fuse_steps=9)
    assert deep.halo == (18, 18) and deep.window == (40, 44)
    with pytest.raises(ValueError, match="fuse_steps"):
        StencilPlan(2, "swc", (4, 8), (2, 2), (12, 24), 1, 1, "float32",
                    fuse_steps=0)


@pytest.mark.parametrize("fuse_steps", (9, 12))
@pytest.mark.parametrize("strategy", ("swc", "swc_stream", "tc"))
def test_depth_beyond_8_matches_jax(strategy, fuse_steps):
    """ROADMAP C2's case: 2-D (64, 64), order 2, f32, one call of depth
    9 or 12; the reference plans swc:f9:o2, swc_stream:sy:f9:o2 and
    tc:f9:o2 (and f12) and runs them in interpret mode."""
    shape = (64, 64)
    jp = jd.DiffusionProblem(shape, accuracy=2)
    f0 = jp.init_field(seed=6)
    jop = jp.step_op(strategy, fuse_steps=fuse_steps)
    want = jintegrate(jop, f0, fuse_steps)
    jplan = jops.plan_for_nd(jop.ops, (1,) + tuple(n + 2 * fuse_steps
                                                   for n in shape),
                             1, strategy=strategy, fuse_steps=fuse_steps)
    sy = ":sy" if strategy == "swc_stream" else ""
    assert jplan.strategy_id == f"{strategy}{sy}:f{fuse_steps}:o2"
    op = td.DiffusionProblem(shape, accuracy=2).step_op(
        strategy, fuse_steps=fuse_steps, device=CPU)
    plan = plan_for_nd(op.ops, (1,) + tuple(n + 2 * fuse_steps for n in shape),
                       1, strategy=strategy, fuse_steps=fuse_steps)
    assert plan.fuse_steps == fuse_steps
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    got = tintegrate(op, torch.from_numpy(np.array(f0)), fuse_steps)
    assert got.shape == (1,) + shape
    assert _rel(got.numpy(), want) <= TOL["float32"]


@pytest.mark.parametrize("strategy", ("swc", "swc_stream", "tc"))
def test_a_depth_that_fits_no_tile_raises_the_fit_error(strategy):
    """Rank 3, order 6, depth 9: a halo of 27 points a side (54 per
    axis) leaves no tile that fits 227 KB; the planner says so."""
    ops = td.DiffusionProblem((64,) * 3).step_op(strategy, device=CPU).ops
    with pytest.raises(ValueError, match="no (swc_stream )?tile fits"):
        plan_stencil(ops, (1,) + (64 + 54,) * 3, 1, strategy=strategy,
                     fuse_steps=9)


def test_smem_bytes_is_the_temporal_layout():
    """Counted by hand from csrc/fused_stencil_temporal.cu's layout."""
    ops = ts.derivative_operator_set(3, 6)  # 10 operators, 148 taps
    pair = plan_for_nd(ops, (8, 268, 268, 268), 16, aux_shape=(8, 262, 262, 262),
                       block=(1, 8, 32), fuse_steps=2, max_threads=256)
    assert pair.block == (1, 8, 32) and pair.stage_buffers == 2
    window = 13 * 20 * 44 * 4  # tile + 2rS, one field
    mid = 8 * (7 * 14 * 38) * 4  # sweep 0's 8 fields
    carry = 8 * 256 * 4  # its w' cut to the tile
    taps = 148 * 8 + 11 * 4
    assert pair.smem_bytes == 2 * window + mid + carry + taps == 220_108
    diff = td.DiffusionProblem((512,) * 3).step_op("swc", device=CPU).ops
    deep = plan_stencil(diff, (1,) + (512 + 18,) * 3, 1, fuse_steps=3)
    assert deep.block == (4, 8, 32) and deep.stage_buffers == 1
    sizes = [22 * 26 * 50, 16 * 20 * 44, 10 * 14 * 38]  # window, sweeps 0, 1
    assert deep.smem_bytes == 4 * sum(sizes) + diff.taps_per_point * 8 + 2 * 4


def test_tile_shrinks_to_fit_and_raises_when_nothing_fits():
    ops = ts.derivative_operator_set(3, 6)
    f64 = plan_stencil(ops, (8,) + (268,) * 3, 16, n_aux=8, block=(1, 8, 32),
                       dtype="float64", fuse_steps=2, max_threads=256)
    assert f64.block == (1, 2, 32)  # halved along y until it fits
    assert f64.stage_buffers == 1 and f64.smem_bytes <= SMEM_PER_BLOCK
    # ...and keeps the kind's 256 threads, which loop over sweep 0's
    # (7, 8, 38) points.
    assert f64.threads == 256
    diff = td.DiffusionProblem((256,) * 3).step_op("swc", device=CPU).ops
    deep = plan_stencil(diff, (1,) + (256 + 18,) * 3, 1, dtype="float64",
                        fuse_steps=3)
    assert deep.block == (1, 1, 32) and deep.threads == 1024
    tiny = plan_stencil(diff, (1, 4 + 12, 4 + 12, 4 + 12), 1, fuse_steps=2)
    assert tiny.threads == 10 * 10 * 10  # no more threads than points
    # The explicit tile at depth 1 stays as given.
    assert plan_stencil(ops, (8,) + (262,) * 3, 16, n_aux=8,
                        block=(1, 8, 32), dtype="float64").block == (1, 8, 32)
    with pytest.raises(ValueError, match="no tile fits"):
        plan_stencil(ops, (8,) + (274,) * 3, 16, n_aux=8, block=(1, 8, 32),
                     fuse_steps=3, max_threads=256)


def test_wrapper_checks_depth_operands():
    ops = ts.derivative_operator_set(3, 6)
    phi = tm.mhd_substep_device_phi(tm.MHDParams(), 0.0, 1 / 3, 1e-3)
    fp = torch.zeros(8, 20, 20, 28)  # (8, 8, 16) + 2 * 6
    plan = plan_for_nd(ops, tuple(fp.shape), 16, aux_shape=(8, 14, 14, 22),
                       block=(1, 8, 16), fuse_steps=2, max_threads=256)
    with pytest.raises(ValueError, match="aux shape"):
        emit.fused_stencil_swc(fp, ops, phi, plan,
                               aux=torch.zeros(8, 8, 8, 16))
    with pytest.raises(ValueError, match="2 fused sweeps"):
        emit.fused_stencil_swc(fp, ops, (phi,) * 3, plan,
                               aux=torch.zeros(8, 14, 14, 22))
    out = emit.fused_stencil_swc(fp, ops, (phi, phi), plan,
                                 aux=torch.zeros(8, 14, 14, 22))
    assert out.shape == (16, 8, 8, 16)


def test_phi_sequence_needs_one_kind():
    sub = tm.mhd_substep_device_phi(tm.MHDParams(), 0.0, 1 / 3, 1e-3)
    rhs = tm.mhd_rhs_device_phi(tm.MHDParams())
    assert phi_sequence(sub, 2) == (sub, sub)
    with pytest.raises(ValueError, match="same kind"):
        phi_sequence((sub, rhs), 2)
    with pytest.raises(ValueError, match="same kind"):
        phi_sequence((select_phi("dx"), select_phi("dxx")), 2)
    with pytest.raises(ValueError, match="strategy='hwc'"):
        phi_sequence((sub, lambda d: d["val"]), 2)


def test_cpu_depth_runs_count_no_launch():
    emit.reset_launch_counts()
    p = td.DiffusionProblem((12, 16))
    td.simulate(p, p.init_field(device=CPU), 7, strategy="swc",
                fuse_steps=3, device=CPU)
    s = tm.MHDSolver((8, 8, 16), strategy="swc", fuse_rk_pairs=True,
                     device=CPU)
    s.step(s.init_fields(), 1e-3)
    assert emit.fused_stencil_swc.launches == 0
    assert sum(emit.fused_stencil_swc.launches_by_depth.values()) == 0


# --- trafficmodel copy --------------------------------------------------------


@pytest.mark.parametrize(
    "args",
    [
        ((256, 256), (64, 256), (3, 3), 1, 1, 4),  # README's worked example
        ((512, 512, 512), (4, 8, 32), (3, 3, 3), 1, 1, 4),
        ((256, 256, 256), (1, 8, 32), (3, 3, 3), 8, 16, 4),
    ],
)
@pytest.mark.parametrize("fuse_steps", (1, 2, 3, 4))
def test_trafficmodel_copy_equals_jax(args, fuse_steps):
    assert ttm.stencil_hbm_bytes_per_step(*args, fuse_steps) == (
        jtm.stencil_hbm_bytes_per_step(*args, fuse_steps)
    )
    block, radii = args[1], args[2]
    assert ttm.stencil_redundant_compute_fraction(block, radii, fuse_steps) == (
        jtm.stencil_redundant_compute_fraction(block, radii, fuse_steps)
    )


def test_trafficmodel_readme_numbers():
    args = ((256, 256), (64, 256), (3, 3), 1, 1, 4)
    assert [ttm.stencil_hbm_bytes_per_step(*args, s) for s in (1, 2, 4)] == [
        555584.0, 294016.0, 164096.0,
    ]


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("rank", (1, 2, 3))
@pytest.mark.parametrize("fuse_steps", (2, 3))
def test_temporal_kernel_select_matches_plain_on_card(
    cuda_device, fuse_steps, rank, dtype
):
    fp = torch.from_numpy(_padded(rank, 2, fuse_steps, dtype)).to(cuda_device)
    ops = ts.derivative_operator_set(rank, 4, 0.3)
    emit.reset_launch_counts()
    got = fused_stencil_nd(fp, ops, select_phi("dxx"), 2, strategy="swc",
                           fuse_steps=fuse_steps)
    assert emit.fused_stencil_swc.launches_by_depth[fuse_steps] == 1
    want = ref.fused_stencil_steps(fp, ops, lambda d: d["dxx"], fuse_steps)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_temporal_kernel_mhd_pair_matches_plain_on_card(cuda_device, dtype):
    solver = tm.MHDSolver((16, 24, 32), strategy="swc", device=cuda_device)
    f = solver.init_smooth(0, amplitude=1e-2, dtype=dtype)
    fp = pad(f, 6, "periodic", spatial_axes=(1, 2, 3))
    w = pad(1e-3 * torch.ones_like(f), 3, "periodic", spatial_axes=(1, 2, 3))
    # Substeps 2 and 3: α ≠ 0 in both sweeps, so both read the carry.
    phis = tuple(
        tm.mhd_substep_device_phi(solver.params, a, b, 1e-2)
        for a, b in zip(tm.RK3_ALPHA[1:], tm.RK3_BETA[1:])
    )
    got = fused_stencil_nd(fp, solver.operator_set, phis, 16, aux=w,
                           strategy="swc", block=solver.block, fuse_steps=2)
    want = ref.fused_stencil_steps(fp, solver.operator_set,
                                   [p.torch_fn for p in phis], 2, aux=w)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ("swc", "swc_stream", "tc"))
def test_depth_9_kernel_matches_plain_on_card(cuda_device, strategy):
    """ROADMAP C2's case on the card: one launch of depth 9, the φ
    parameter rows read from the wrapper's device buffer."""
    p = td.DiffusionProblem((64, 64), accuracy=2)
    op = p.step_op(strategy, fuse_steps=9, device=cuda_device)
    f = p.init_field(seed=6, device=cuda_device)
    emit.reset_launch_counts()
    got = op(f)
    assert emit.fused_stencil_swc.launches_by_depth == {9: 1}
    fp = pad(f, [9 * r for r in op.radius_per_axis], "periodic",
             spatial_axes=(1, 2))
    want = ref.fused_stencil_steps(fp, op.ops, op.phi.torch_fn, 9,
                                   tc=strategy == "tc")
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL["float32"]
