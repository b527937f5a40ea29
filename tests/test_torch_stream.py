"""Slowest-axis streaming in the port (``strategy="swc_stream"``) against
the JAX package, plus the stream plan's rules, its shared-memory layout
and fit, the segments of the stream axis, the launch counts and the
trafficmodel copy.

The JAX side runs as ``tests/test_streaming.py`` runs it: the Pallas
stream kernel in interpret mode, on that file's shapes and blocks
(stream extents of several chunks, x not aligned to the default tile).
On the CPU the port's wrapper takes its plain version
(``ref.fused_stencil`` / ``ref.fused_stencil_steps``), so these tests
hold the port's plumbing — plans, padding, the strategy's routing
through every entry point — and its plain arithmetic to the reference.
Tests marked ``cuda`` hold the stream CUDA kernel itself to that plain
version and skip without a card.

Tolerances: f64 1e-12 and f32 1e-5 relative to the largest |value|, as
in the other port parity tests (the two packages sum the same taps in
the same order; XLA and PyTorch round φ's point-wise arithmetic
independently, and the CUDA kernel contracts multiply-adds into FMA).
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import stencil as js  # noqa: E402
from repro.core import trafficmodel as jtm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.physics import diffusion as jd  # noqa: E402
from repro.physics import mhd as jm  # noqa: E402
from repro_torch.core import stencil as ts  # noqa: E402
from repro_torch.core import trafficmodel as ttm  # noqa: E402
from repro_torch.core.boundary import pad  # noqa: E402
from repro_torch.core.fusion import FusedStencilOp  # noqa: E402
from repro_torch.kernels import emit, ref  # noqa: E402
from repro_torch.kernels.ops import fused_stencil_nd, plan_for_nd  # noqa: E402
from repro_torch.kernels.phi import select_phi  # noqa: E402
from repro_torch.kernels.plan import (  # noqa: E402
    SMEM_PER_BLOCK,
    plan_stencil,
)
from repro_torch.physics import diffusion as td  # noqa: E402
from repro_torch.physics import mhd as tm  # noqa: E402

TOL = {"float32": 1e-5, "float64": 1e-12}
# tests/test_streaming.py's shapes and blocks: several chunks along the
# stream axis, room for the deepest carried halo (2·r·S + τ₀ with r = 2,
# S ≤ 3), x not aligned to the default tile.
SHAPES = {2: (20, 24), 3: (15, 10, 24)}
BLOCKS = {2: (4, 12), 3: (3, 5, 12)}
CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _padded(rank, n_f, depth, dtype, r=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n_f,) + tuple(n + 2 * r * depth for n in SHAPES[rank])
    return rng.standard_normal(shape).astype(dtype)


# --- the port against JAX ------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("rank", (2, 3))
@pytest.mark.parametrize("fuse_steps", (1, 2, 3))
def test_stream_select_matches_jax(fuse_steps, rank, dtype):
    """Two fields, the whole order-4 derivative set, φ selects one
    operator, S sweeps per chunk."""
    fp = _padded(rank, 2, fuse_steps, dtype)
    out_t = fused_stencil_nd(
        torch.from_numpy(fp), ts.derivative_operator_set(rank, 4, 0.3),
        select_phi("dxx"), 2, strategy="swc_stream", block=BLOCKS[rank],
        fuse_steps=fuse_steps,
    )
    out_j = jops.fused_stencil_nd(
        jnp.asarray(fp), js.derivative_operator_set(rank, 4, 0.3),
        lambda d: d["dxx"], 2, strategy="swc_stream", block=BLOCKS[rank],
        fuse_steps=fuse_steps, interpret=True,
    )
    assert out_t.shape == (2,) + SHAPES[rank]
    assert out_t.dtype == getattr(torch, dtype)
    assert _rel(out_t.numpy(), out_j) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_mhd_stream_rhs_matches_jax(dtype):
    shape = (16, 16, 16)
    jsolver = jm.MHDSolver(shape, strategy="swc_stream", block=(1, 8, 16))
    f = jsolver.init_smooth(seed=1, amplitude=1e-2, dtype=getattr(jnp, dtype))
    want = jsolver.rhs(f)
    tsolver = tm.MHDSolver(shape, strategy="swc_stream", device=CPU)
    got = tsolver.rhs(torch.from_numpy(np.array(f)))
    assert got.shape == (8,) + shape
    assert _rel(got.numpy(), want) <= TOL[dtype]


def test_mhd_stream_step_matches_swc():
    """The plain RK3 form on swc_stream is the swc step."""
    shape = (8, 8, 16)
    stream = tm.MHDSolver(shape, strategy="swc_stream", device=CPU)
    swc = tm.MHDSolver(shape, strategy="swc", fuse_rk_axpy=True, device=CPU)
    f = stream.init_smooth(2, amplitude=1e-2)
    assert _rel(stream.step(f, 1e-3), swc.step(f, 1e-3)) <= TOL["float64"]


def test_simulate_stream_fuse3_with_remainder_matches_jax():
    """7 steps at depth 3: two depth-3 calls and a depth-1 remainder,
    all on swc_stream."""
    shape = (32, 24)
    f0 = jd.DiffusionProblem(shape).init_field(seed=3)  # float32
    want = jd.simulate(jd.DiffusionProblem(shape), f0, 7,
                       strategy="swc_stream", fuse_steps=3)
    got = td.simulate(td.DiffusionProblem(shape), np.asarray(f0), 7,
                      strategy="swc_stream", fuse_steps=3, device=CPU)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL["float32"]


def test_step_op_and_remainder_keep_the_strategy():
    op = td.DiffusionProblem((24, 16, 16)).step_op(
        "swc_stream", fuse_steps=3, device=CPU)
    assert op.strategy == op.with_depth(1).strategy == "swc_stream"
    assert op.with_depth(1).fuse_steps == 1


# --- the rules of the reference -----------------------------------------------


def test_rank1_raises_naming_swc_in_both_packages():
    t_ops, j_ops = ts.derivative_operator_set(1, 4), js.derivative_operator_set(1, 4)
    with pytest.raises(ValueError, match="strategy='swc'"):
        plan_stencil(t_ops, (1, 68), 1, strategy="swc_stream")
    with pytest.raises(ValueError, match="strategy='swc'"):
        jplan.plan_stencil(j_ops, (1, 68), 1, strategy="swc_stream")
    with pytest.raises(ValueError, match="'swc'"):
        FusedStencilOp(t_ops, select_phi("val"), 1, strategy="swc_stream",
                       device=CPU)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(n_aux=1, n_out=2), "use strategy='swc'"),
        (dict(unroll=2), "unroll"),
    ],
)
def test_aux_and_unroll_raise_as_in_the_reference(kw, match):
    kw = dict(kw)
    n_out = kw.pop("n_out", 1)
    with pytest.raises(ValueError, match=match):
        plan_stencil(ts.derivative_operator_set(3, 4), (1, 19, 14, 28),
                     n_out, strategy="swc_stream", **kw)
    with pytest.raises(ValueError, match=match):
        jplan.plan_stencil(js.derivative_operator_set(3, 4), (1, 19, 14, 28),
                           n_out, strategy="swc_stream", **kw)


def test_carried_halo_bound_and_chunk_clamp_match_the_reference():
    # A stream extent that cannot hold 2·r·S carried planes plus a chunk.
    t_ops, j_ops = ts.derivative_operator_set(2, 4), js.derivative_operator_set(2, 4)
    with pytest.raises(ValueError, match="carr"):
        plan_stencil(t_ops, (1, 10 + 12, 24 + 12), 1, strategy="swc_stream",
                     fuse_steps=3)
    with pytest.raises(ValueError, match="carried"):
        jplan.plan_stencil(j_ops, (1, 10 + 12, 24 + 12), 1,
                           strategy="swc_stream", fuse_steps=3)
    # The planner shrinks the chunk to leave room, as the reference's.
    for extent, block in ((20, (16, 12)), (30, (10, 12)), (15, (15, 12))):
        t = plan_stencil(t_ops, (1, extent + 12, 24 + 12), 1,
                         strategy="swc_stream", block=block, fuse_steps=3)
        j = jplan.plan_stencil(j_ops, (1, extent + 12, 24 + 12), 1,
                               strategy="swc_stream", block=block,
                               fuse_steps=3)
        assert t.block[0] == j.block[0]
        assert t.interior[0] >= 12 + t.block[0]
    assert t.stream_axis == j.stream_axis == 0


@pytest.mark.parametrize("form", ("fuse_rk_axpy", "fuse_rk_pairs"))
def test_mhd_fused_axpy_forms_raise_on_stream(form):
    shape = (8, 8, 16)
    jsolver = jm.MHDSolver(shape, strategy="swc_stream", block=(1, 8, 16),
                           **{form: True})
    f = jsolver.init_smooth(seed=1, amplitude=1e-2)
    with pytest.raises(ValueError, match="'swc'"):
        jsolver.step(f, 1e-3)
    tsolver = tm.MHDSolver(shape, strategy="swc_stream", device=CPU,
                           **{form: True})
    emit.reset_launch_counts()
    with pytest.raises(ValueError, match="use strategy='swc'"):
        tsolver.step(torch.from_numpy(np.array(f)), 1e-3)
    assert emit.fused_stencil_swc.launches == 0


# --- the stream plan on Hopper ------------------------------------------------


def test_stream_smem_bytes_is_the_kernel_layout():
    """Counted by hand from csrc/fused_stencil_stream.cu's layouts: the
    depth-1 ring body's (stream_body.cuh) for the MHD RHS in f32, the
    one-buffer body's at depth 3."""
    ops = ts.derivative_operator_set(3, 6)  # 10 operators, 148 taps
    rhs = plan_for_nd(ops, (8, 262, 262, 262), 8, strategy="swc_stream",
                      block=(1, 8, 32), max_threads=256, n_slots=10)
    # Window 14 x 38; a row of 38 + 3 elements congruent to 262 = 2 (mod
    # 4): pitch 42; plane 14 x 42 = 588 = 262^2 (mod 4); the ring holds
    # one chunk and the 6 carried planes, 7 slots (7 x 588 = 0 mod 4); a
    # field reaches element 3 + 6 x 588 + 13 x 42 + 38 = 4115, 4116
    # elements (= 262^3 mod 4).
    ring = rhs.stream_ring
    assert (ring.pitch, ring.plane, ring.period, ring.field_stride) == (
        42, 588, 7, 4116)
    work = 8 * 4116 * 4  # 8 fields' rings
    taps = 7 * 148 * 8 + 11 * 4  # one tap row per slot, the starts
    sums = 10 * 8 * 256 * 4  # φ's inputs, from a 16-byte boundary
    # 512 threads: two fields of the 256-point plane a round, one point
    # each for φ.
    assert rhs.block == (1, 8, 32) and rhs.threads == 512
    assert rhs.stream_depth1 and rhs.stage_buffers == 1
    assert rhs.smem_bytes == -(-(work + taps) // 16) * 16 + sums == 221_968
    diff = td.DiffusionProblem((512,) * 3).step_op("swc", device=CPU).ops
    deep = plan_stencil(diff, (1,) + (512 + 18,) * 3, 1,
                        strategy="swc_stream", fuse_steps=3)
    assert deep.block == (4, 8, 32) and deep.threads == 1024
    sizes = [22 * 26 * 50, 4 * 26 * 50, 16 * 20 * 44, 10 * 14 * 38]
    assert deep.smem_bytes == 4 * sum(sizes) + 19 * 8 + 2 * 4 == 212_960


def test_stream_fit_halves_chunk_then_cross_tile_and_raises():
    ops = ts.derivative_operator_set(3, 6)
    f64 = plan_stencil(ops, (8, 262, 262, 262), 8, strategy="swc_stream",
                       block=(4, 8, 32), dtype="float64", max_threads=256,
                       n_slots=10)
    assert not f64.stream_depth1  # the f64 MHD RHS keeps the one-buffer body
    assert f64.block == (1, 4, 32)  # chunk to 1, then y halved
    assert f64.smem_bytes <= SMEM_PER_BLOCK and f64.threads == 128
    diff = td.DiffusionProblem((64,) * 3).step_op("swc", device=CPU).ops
    deep = plan_stencil(diff, (1,) + (64 + 18,) * 3, 1, dtype="float64",
                        strategy="swc_stream", fuse_steps=3)
    assert deep.block[0] < 4 and deep.smem_bytes <= SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="no swc_stream tile fits"):
        plan_stencil(ops, (8,) + (268,) * 3, 8, strategy="swc_stream",
                     block=(1, 8, 32), fuse_steps=2, max_threads=256)


@pytest.mark.parametrize(
    "interior,block,radius,want",
    [
        ((256, 256, 256), (1, 8, 32), 3, 2),  # MHD: 256 cross tiles
        ((8192, 8192), (16, 64), 3, 4),  # rank 2: 128 cross tiles
        ((512, 512, 512), (4, 8, 32), 3, 1),  # 1024 cross tiles suffice
        ((15, 10, 24), (3, 5, 12), 2, 1),  # too short to cut
    ],
)
def test_segments_give_blocks_to_every_sm(interior, block, radius, want):
    ops = ts.derivative_operator_set(len(interior), 2 * radius)
    padded = (1,) + tuple(n + 2 * radius for n in interior)
    plan = plan_stencil(ops, padded, 1, strategy="swc_stream", block=block)
    assert plan.block == block and plan.segments == want
    with pytest.raises(ValueError, match="segments"):
        dataclasses.replace(plan, segments=plan.n_chunks + 1)
    with pytest.raises(ValueError, match="segments"):
        dataclasses.replace(plan, strategy="swc", segments=2)


def test_stream_geometry_keeps_the_stream_axis_as_z():
    ops = ts.derivative_operator_set(2, 4)
    plan = plan_stencil(ops, (2, 24, 28), 2, strategy="swc_stream",
                        block=(4, 12))
    assert emit.kernel_name(plan) == "fused_stencil_stream"
    g = emit.geometry(plan, [0])
    assert list(g[3:15]) == [20, 1, 24, 24, 1, 28, 2, 0, 2, 4, 1, 12]
    assert len(g) == emit.GEOM_LEN
    swc = plan_stencil(ops, (2, 24, 28), 2, block=(4, 12))
    assert list(emit.geometry(swc, [0])[3:6]) == [1, 20, 24]


def test_cpu_stream_runs_count_no_launch():
    emit.reset_launch_counts()
    p = td.DiffusionProblem((24, 16))
    td.simulate(p, p.init_field(device=CPU), 7, strategy="swc_stream",
                fuse_steps=3, device=CPU)
    s = tm.MHDSolver((8, 8, 16), strategy="swc_stream", device=CPU)
    s.step(s.init_fields(), 1e-3)
    assert emit.fused_stencil_swc.launches == 0
    assert sum(emit.fused_stencil_swc.launches_by_kernel.values()) == 0


# --- trafficmodel copy --------------------------------------------------------


@pytest.mark.parametrize(
    "args",
    [
        ((512, 512, 512), (4, 8, 32), (3, 3, 3), 1, 1, 4),
        ((256, 256, 256), (1, 8, 32), (3, 3, 3), 8, 8, 4),
        ((8192, 8192), (16, 64), (3, 3), 1, 1, 4),
        ((15, 10, 24), (3, 5, 12), (2, 2, 2), 2, 2, 8),
    ],
)
@pytest.mark.parametrize("fuse_steps", (1, 2, 3))
def test_stream_trafficmodel_copy_equals_jax(args, fuse_steps):
    got = ttm.stencil_stream_hbm_bytes_per_step(*args, fuse_steps)
    assert got == jtm.stencil_stream_hbm_bytes_per_step(*args, fuse_steps)
    # Each further segment reads the 2·r₀·S carried planes once more.
    domain, block, radii, n_f, _, item = args
    cols = 1
    for n, t in zip(domain[1:], block[1:]):
        cols *= -(-n // t)
    cross = 1
    for t, r in zip(block[1:], radii[1:]):
        cross *= t + 2 * r * fuse_steps
    extra = cols * n_f * cross * 2 * radii[0] * fuse_steps * item
    assert ttm.stencil_stream_hbm_bytes_per_step(
        *args, fuse_steps, segments=3
    ) == pytest.approx(got + 2 * extra / fuse_steps, rel=1e-12)


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("rank", (2, 3))
@pytest.mark.parametrize("fuse_steps", (1, 2, 3))
def test_stream_kernel_select_matches_plain_on_card(
    cuda_device, fuse_steps, rank, dtype
):
    fp = torch.from_numpy(_padded(rank, 2, fuse_steps, dtype)).to(cuda_device)
    ops = ts.derivative_operator_set(rank, 4, 0.3)
    plan = plan_for_nd(ops, tuple(fp.shape), 2, strategy="swc_stream",
                       block=BLOCKS[rank], dtype=dtype, fuse_steps=fuse_steps)
    assert emit.kernel_smem_bytes(plan) == plan.smem_bytes
    emit.reset_launch_counts()
    got = fused_stencil_nd(fp, ops, select_phi("dxx"), 2,
                           strategy="swc_stream", block=BLOCKS[rank],
                           fuse_steps=fuse_steps)
    assert emit.fused_stencil_swc.launches_by_kernel == {
        "fused_stencil_stream": 1
    }
    want = ref.fused_stencil_steps(fp, ops, lambda d: d["dxx"], fuse_steps)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_stream_kernel_mhd_rhs_matches_plain_on_card(cuda_device, dtype):
    solver = tm.MHDSolver((16, 24, 32), strategy="swc_stream",
                          device=cuda_device)
    f = solver.init_smooth(0, amplitude=1e-2, dtype=dtype)
    got = solver.rhs(f)
    want = ref.fused_stencil(
        pad(f, 3, "periodic", spatial_axes=(1, 2, 3)), solver.operator_set,
        tm.mhd_rhs_device_phi(solver.params).torch_fn)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL[dtype]


@pytest.mark.cuda
def test_stream_kernel_in_segments_matches_plain_on_card(cuda_device):
    ops = ts.derivative_operator_set(3, 4, 0.3)
    fp = torch.from_numpy(_padded(3, 2, 2, "float64")).to(cuda_device)
    fp = torch.cat([fp] * 4, dim=1)[:, : 60 + 8].contiguous()  # extent 60
    plan = dataclasses.replace(
        plan_for_nd(ops, tuple(fp.shape), 2, strategy="swc_stream",
                    block=BLOCKS[3], dtype="float64", fuse_steps=2),
        segments=4,
    )
    got = emit.fused_stencil_swc(fp, ops, select_phi("dxx"), plan)
    want = ref.fused_stencil_steps(fp, ops, lambda d: d["dxx"], 2)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL["float64"]
