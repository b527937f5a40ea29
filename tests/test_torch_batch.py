"""The ensemble batch axis in the port (B5) against the JAX package, plus
the batched plan's rules, the member grid axis and the wrapper's
batched operand checks.

The JAX side runs as ``tests/test_batch.py`` runs it: the batched Pallas
lowering (members flattened onto the field axis) in interpret mode. On
the CPU the port's wrapper takes its batched plain versions
(``ref.fused_stencil_batched`` / ``ref.fused_stencil_steps_batched``),
so these tests hold the port's plumbing — batch inference, member-axis
padding, the dispatch of every entry point — and its plain arithmetic
to the reference. Tests marked ``cuda`` hold the batched CUDA kernels to
that plain version and each member to the unbatched launch on it, and
skip without a card.

Tolerances: f64 1e-12 and f32 1e-5 relative to the largest |value|, as
in the other port parity tests (the same taps summed in the same order;
XLA and PyTorch round φ's point-wise arithmetic independently). On the
card a batched member equals the unbatched launch exactly: its block
runs the same instructions on the same values.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import fusion as jf  # noqa: E402
from repro.core import stencil as js  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.physics import diffusion as jd  # noqa: E402
from repro.physics import mhd as jm  # noqa: E402
from repro_torch.core import stencil as ts  # noqa: E402
from repro_torch.core.fusion import integrate  # noqa: E402
from repro_torch.kernels import emit, ref  # noqa: E402
from repro_torch.kernels.ops import fused_stencil_nd, plan_for_nd  # noqa: E402
from repro_torch.kernels.phi import select_phi  # noqa: E402
from repro_torch.kernels.plan import (  # noqa: E402
    MAX_GRID_Z,
    MIN_STREAM_BLOCKS,
    _stream_segments,
    plan_stencil,
)
from repro_torch.physics import diffusion as td  # noqa: E402
from repro_torch.physics import mhd as tm  # noqa: E402

TOL = {"float32": 1e-5, "float64": 1e-12}
# tests/test_batch.py's domains and blocks.
DOMAINS = {1: (64,), 2: (12, 24), 3: (8, 10, 16)}
BLOCKS = {1: (32,), 2: (6, 12), 3: (3, 5, 8)}
CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _diffusion_sets(rank):
    """The merged diffusion stencil (accuracy 2), named "step", in both
    packages."""
    jp = jd.DiffusionProblem(DOMAINS[rank], accuracy=2)
    tp = td.DiffusionProblem(DOMAINS[rank], accuracy=2)
    jspec = dataclasses.replace(jp.merged_stencil(), name="step")
    tspec = dataclasses.replace(tp.merged_stencil(), name="step")
    return js.OperatorSet((jspec,)), ts.OperatorSet((tspec,))


def _batched_fields(batch, n_f, rank, halo, dtype, seed=0):
    """(batch, n_f, *spatial) random fields, wrap-padded by ``halo``."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((batch, n_f) + DOMAINS[rank]).astype(dtype)
    return np.pad(f, ((0, 0), (0, 0)) + ((halo, halo),) * rank, mode="wrap")


# --- batched ops against JAX ----------------------------------------------------

SWEEP = [
    (batch, rank, strategy, fuse_steps)
    for batch in (1, 4)
    for rank in (1, 2, 3)
    for strategy in ("swc", "swc_stream")
    for fuse_steps in (1, 2)
    if not (strategy == "swc_stream" and rank == 1)
]


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("batch,rank,strategy,fuse_steps", SWEEP)
def test_batched_select_matches_jax(batch, rank, strategy, fuse_steps, dtype):
    """Diffusion's merged stencil on two fields per member, φ selecting
    it (a self-map, so depth 2 chains), member-major in the reference."""
    jops_set, tops_set = _diffusion_sets(rank)
    fp = _batched_fields(batch, 2, rank, fuse_steps, dtype)
    got = fused_stencil_nd(
        torch.from_numpy(fp), tops_set, select_phi("step"), 2,
        strategy=strategy, block=BLOCKS[rank], fuse_steps=fuse_steps,
    )
    want = jops.fused_stencil_nd(
        jnp.asarray(fp), jops_set, lambda d: d["step"], 2,
        strategy=strategy, block=BLOCKS[rank], fuse_steps=fuse_steps,
        interpret=True,
    )
    assert got.shape == (batch, 2) + DOMAINS[rank]
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got.numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("substep", (False, True))
def test_batched_mhd_matches_jax(substep):
    """The MHD RHS, and the fused RK substep with its aux w, on a
    two-member ensemble at depth 1."""
    shape = (8, 8, 16)
    jsol = jm.MHDSolver(shape, strategy="swc", block=(4, 8, 16))
    f = np.stack([
        np.asarray(jsol.init_smooth(seed=s, amplitude=1e-2,
                                    dtype=jnp.float64))
        for s in (1, 2)
    ])
    fp = np.pad(f, ((0, 0), (0, 0)) + ((3, 3),) * 3, mode="wrap")
    tparams = tm.MHDParams()
    if substep:
        w = 1e-3 * np.random.default_rng(5).standard_normal(f.shape)
        alpha, beta, dt = jm.RK3_ALPHA[1], jm.RK3_BETA[1], 1e-3
        jphi = jsol._substep_phi(alpha, beta, dt)
        tphi = tm.mhd_substep_device_phi(tparams, alpha, beta, dt)
        n_out = 16
    else:
        w = None
        jphi = jm.mhd_rhs_phi(jsol.params)
        tphi, n_out = tm.mhd_rhs_device_phi(tparams), 8
    want = jops.fused_stencil_nd(
        jnp.asarray(fp), jsol.operator_set, jphi, n_out,
        aux=None if w is None else jnp.asarray(w), strategy="swc",
        block=(4, 8, 16), interpret=True,
    )
    emit.reset_launch_counts()
    got = fused_stencil_nd(
        torch.from_numpy(fp), ts.derivative_operator_set(3, 6, jsol.spacing),
        tphi, n_out, aux=None if w is None else torch.from_numpy(w),
        strategy="swc", block=(1, 8, 16),
    )
    assert got.shape == (2, n_out) + shape
    assert _rel(got.numpy(), want) <= TOL["float64"]
    assert emit.fused_stencil_swc.launches == 0  # the CPU runs no kernel


@pytest.mark.parametrize(
    "strategy,fuse_steps,n_steps",
    [("hwc", 1, 3), ("swc", 1, 3), ("swc", 2, 5), ("swc_stream", 2, 5)],
)
def test_batched_op_and_integrate_match_jax(strategy, fuse_steps, n_steps):
    """``FusedStencilOp.forward`` pads only the spatial axes of a (B, n_f,
    *spatial) stack, and ``integrate`` — unchanged — advances the whole
    ensemble, a remainder (n_steps % fuse_steps) included."""
    shape = (32, 16)  # room for the 2·r·S = 12 carried planes of a stream
    jp, tp = jd.DiffusionProblem(shape), td.DiffusionProblem(shape)
    rng = np.random.default_rng(11)
    f0 = rng.uniform(-1e-5, 1e-5, (3, 1) + shape)
    jop = jp.step_op(strategy, None, fuse_steps)
    top = tp.step_op(strategy, None, fuse_steps, device=CPU)
    one = top(torch.from_numpy(f0))
    assert one.shape == f0.shape
    assert _rel(one.numpy(), jop(jnp.asarray(f0))) <= TOL["float64"]
    want = jf.integrate(jop, jnp.asarray(f0), n_steps)
    got = integrate(top, torch.from_numpy(f0), n_steps)
    assert _rel(got.numpy(), want) <= TOL["float64"]
    # Each member is the single-member integration of its own field.
    for m in range(3):
        solo = integrate(top, torch.from_numpy(f0[m]), n_steps)
        assert torch.equal(got[m], solo)


def test_batched_ref_is_the_member_loop():
    ops = ts.derivative_operator_set(2, 2, 0.4)
    fp = torch.from_numpy(_batched_fields(3, 2, 2, 3, "float64"))
    phi = select_phi("dxx").torch_fn
    got = ref.fused_stencil_batched(fp, ops, phi)
    for m in range(3):
        assert torch.equal(got[m], ref.fused_stencil(fp[m], ops, phi))
    got = ref.fused_stencil_steps_batched(fp, ops, phi, 3)
    for m in range(3):
        assert torch.equal(got[m], ref.fused_stencil_steps(fp[m], ops, phi, 3))


def test_forward_rejects_a_stack_of_the_wrong_rank():
    op = td.DiffusionProblem((8, 8)).step_op("swc", device=CPU)
    with pytest.raises(ValueError, match="batch, n_f"):
        op(torch.zeros(8, 8))


# --- the batched plan's rules ---------------------------------------------------


def test_batch_is_inferred_from_the_operand_rank():
    t_ops, j_ops = _diffusion_sets(3)
    shape = (5, 2, 10, 12, 18)
    t = plan_stencil(t_ops, shape, 2, block=BLOCKS[3])
    j = jplan.plan_stencil(j_ops, shape, 2, block=BLOCKS[3])
    assert t.batch == j.batch == 5
    assert (t.n_f, t.interior) == (j.n_f, j.interior) == (2, (8, 10, 16))
    assert plan_stencil(t_ops, shape[1:], 2).batch == 1
    # An explicit batch turns an unbatched shape into a B-member plan...
    assert plan_stencil(t_ops, shape[1:], 2, batch=5).batch == 5
    # ...and must agree with a batched one.
    with pytest.raises(ValueError, match="disagrees"):
        plan_stencil(t_ops, shape, 2, batch=4)
    with pytest.raises(ValueError, match="disagrees"):
        jplan.plan_stencil(j_ops, shape, 2, batch=4)
    with pytest.raises(ValueError, match="batch must be >= 1"):
        dataclasses.replace(t, batch=0)


def test_batched_aux_temporal_raises_as_in_the_reference():
    t_ops = ts.derivative_operator_set(2, 2)
    j_ops = js.derivative_operator_set(2, 2)
    for plan_fn, o in ((plan_stencil, t_ops), (jplan.plan_stencil, j_ops)):
        with pytest.raises(ValueError, match="aux carries"):
            plan_fn(o, (4, 1, 16, 28), 2, n_aux=1, fuse_steps=2)
        plan_fn(o, (4, 1, 14, 26), 2, n_aux=1)  # depth 1: fine
        plan_fn(o, (1, 1, 16, 28), 2, n_aux=1, fuse_steps=2)  # B = 1: fine


def test_plan_for_nd_reads_aux_rows_behind_the_member_axis():
    ops = ts.derivative_operator_set(2, 2)
    plan = plan_for_nd(ops, (4, 1, 14, 26), 2, aux_shape=(4, 1, 12, 24))
    assert (plan.batch, plan.n_aux) == (4, 1)


def test_stream_segments_count_the_member_axis():
    """``_stream_segments``' block count includes the member axis: the
    rank-2 8192² stream at (16, 64) has 128 cross tiles, so one member
    is cut in 4 segments; 8 members give 1,024 blocks uncut, and every
    segment would re-read its 2h₀ leading planes for nothing."""
    interior, tile, radii = (8192, 8192), (16, 64), (3, 3)
    assert _stream_segments(tile, interior, radii, 1) == 4
    assert _stream_segments(tile, interior, radii, 1, batch=2) == 2
    assert _stream_segments(tile, interior, radii, 1, batch=8) == 1
    ops = ts.derivative_operator_set(2, 6)
    for batch, want in ((1, 4), (2, 2), (3, 1), (8, 1)):
        plan = plan_stencil(ops, (batch, 1, 8198, 8198), 1,
                            strategy="swc_stream", block=(16, 64))
        assert plan.segments == want
        assert plan.grid_z == batch * want
        assert batch * 128 * want >= MIN_STREAM_BLOCKS


@pytest.mark.parametrize(
    "shape,strategy,block,per_member",
    [
        ((1, 70), "swc", (32,), 1),  # rank 1: the grid's z is the member
        ((1, 14, 26), "swc", (6, 12), 1),
        ((1, 18, 14, 26), "swc", (4, 6, 12), 4),  # z tiles
        ((1, 130, 14, 26), "swc_stream", (4, 6, 12), 8),  # segments
    ],
)
def test_grid_z_folds_members_and_raises_past_the_cuda_limit(
    shape, strategy, block, per_member
):
    ops = ts.derivative_operator_set(len(shape) - 1, 2)
    plan = plan_stencil(ops, shape, 1, strategy=strategy, block=block)
    assert plan.grid_z == per_member
    batch = MAX_GRID_Z // per_member
    assert dataclasses.replace(plan, batch=batch).grid_z <= MAX_GRID_Z
    if plan.persistent:
        # Depth 1 on swc is a persistent kernel: its blocks walk the
        # members, so gridDim.z does not bind it; the temporal kernel,
        # which folds the member into blockIdx.z, is bound.
        assert dataclasses.replace(plan, batch=batch + 1).walk_items == (
            (batch + 1) * plan.walk_items)
        plan = dataclasses.replace(plan, fuse_steps=2)
    with pytest.raises(ValueError, match="gridDim.z"):
        dataclasses.replace(plan, batch=batch + 1)


# --- the wrapper ----------------------------------------------------------------


def test_wrapper_checks_batched_operands():
    ops = ts.derivative_operator_set(2, 2)
    plan = plan_for_nd(ops, (3, 1, 14, 26), 1, block=(6, 12))
    phi = select_phi("val")
    assert plan.batch == 3
    out = emit.fused_stencil_swc(torch.zeros(3, 1, 14, 26), ops, phi, plan)
    assert out.shape == (3, 1, 12, 24)
    with pytest.raises(ValueError, match="serves 3 members"):
        emit.fused_stencil_swc(torch.zeros(1, 14, 26), ops, phi, plan)
    with pytest.raises(ValueError, match="f_padded shape"):
        emit.fused_stencil_swc(torch.zeros(2, 1, 14, 26), ops, phi, plan)
    aux_plan = plan_for_nd(ops, (3, 8, 14, 26), 16,
                           aux_shape=(3, 8, 12, 24), block=(6, 12))
    substep = tm.mhd_substep_device_phi(tm.MHDParams(), 0.0, 1.0, 1e-3)
    with pytest.raises(ValueError, match="aux shape"):
        emit.fused_stencil_swc(torch.zeros(3, 8, 14, 26), ops, substep,
                               aux_plan, aux=torch.zeros(8, 12, 24))


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize(
    "rank,strategy,fuse_steps",
    [(1, "swc", 1), (2, "swc", 1), (3, "swc", 1), (3, "swc", 2),
     (2, "swc_stream", 1), (3, "swc_stream", 2)],
)
def test_batched_kernel_matches_plain_and_each_member_on_card(
    cuda_device, rank, strategy, fuse_steps, dtype
):
    _, ops = _diffusion_sets(rank)
    fp = torch.from_numpy(
        _batched_fields(3, 2, rank, fuse_steps, dtype)
    ).to(cuda_device)
    phi = select_phi("step")
    emit.reset_launch_counts()
    got = fused_stencil_nd(fp, ops, phi, 2, strategy=strategy,
                           block=BLOCKS[rank], fuse_steps=fuse_steps)
    assert emit.fused_stencil_swc.launches == 1
    want = ref.fused_stencil_steps_batched(fp, ops, phi.torch_fn, fuse_steps)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL[dtype]
    for m in range(3):
        solo = fused_stencil_nd(fp[m], ops, phi, 2, strategy=strategy,
                                block=BLOCKS[rank], fuse_steps=fuse_steps)
        assert torch.equal(got[m], solo)
