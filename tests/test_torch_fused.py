"""The port's fused stencil (``repro_torch.kernels.ops.fused_stencil_nd``)
against the JAX package's ``fused_stencil_nd(strategy="swc")`` in
interpret mode, plus the wrapper's contract: the tap table and
geometry handed to the CUDA kernel, operand checks, and no launch
counted on the CPU path.

Tolerances: f64 1e-12 and f32 1e-5 relative to the largest |value| —
the two packages sum the same taps in the same order, but XLA and
PyTorch round φ's point-wise arithmetic independently (and the CUDA
kernel contracts multiply-adds into FMA). Tests marked ``cuda`` hold the
kernel itself against its plain version and skip without a card.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import stencil as js  # noqa: E402
from repro.kernels.ops import fused_stencil_nd as jax_fused  # noqa: E402
from repro.physics import mhd as jmhd  # noqa: E402
from repro_torch.core import stencil as ts  # noqa: E402
from repro_torch.core.boundary import pad  # noqa: E402
from repro_torch.core.fusion import FusedStencilOp  # noqa: E402
from repro_torch.kernels import emit, ref  # noqa: E402
from repro_torch.kernels.ops import fused_stencil_nd, plan_for_nd  # noqa: E402
from repro_torch.kernels.phi import DevicePhi, select_phi  # noqa: E402
from repro_torch.physics import mhd as tmhd  # noqa: E402

TOL = {"float32": 1e-5, "float64": 1e-12}
SHAPES = {1: (40,), 2: (12, 20), 3: (8, 10, 16)}
JAX_BLOCKS = {1: (40,), 2: (12, 20), 3: (8, 10, 16)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _padded(rank, n_f, dtype, seed=0):
    rng = np.random.default_rng(seed)
    r = 2  # accuracy 4
    shape = (n_f,) + tuple(n + 2 * r for n in SHAPES[rank])
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("rank", (1, 2, 3))
def test_swc_select_matches_jax(rank, dtype):
    """Two fields through the whole derivative set, φ selects one op."""
    fp = _padded(rank, 2, dtype)
    name = "dxx"
    out_t = fused_stencil_nd(
        torch.from_numpy(fp), ts.derivative_operator_set(rank, 4, 0.5),
        select_phi(name), 2, strategy="swc",
    )
    out_j = jax_fused(
        jnp.asarray(fp), js.derivative_operator_set(rank, 4, 0.5),
        lambda d: d[name], 2, strategy="swc", block=JAX_BLOCKS[rank],
    )
    assert out_t.dtype == getattr(torch, dtype)
    assert _rel(out_t.numpy(), out_j) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("rank", (1, 2, 3))
def test_aux_matches_jax(rank, dtype):
    """An aux operand reaches φ: the port's hwc (any φ) against the JAX
    swc kernel in interpret mode."""
    fp = _padded(rank, 2, dtype, seed=1)
    aux = np.random.default_rng(2).standard_normal(
        (2,) + SHAPES[rank]
    ).astype(dtype)

    def phi(d, a):
        return d["val"] + 0.25 * d["dx"] * a

    out_t = fused_stencil_nd(
        torch.from_numpy(fp), ts.derivative_operator_set(rank, 4),
        phi, 2, aux=torch.from_numpy(aux), strategy="hwc",
    )
    out_j = jax_fused(
        jnp.asarray(fp), js.derivative_operator_set(rank, 4), phi, 2,
        aux=jnp.asarray(aux), strategy="swc", block=JAX_BLOCKS[rank],
    )
    assert _rel(out_t.numpy(), out_j) <= TOL[dtype]


@pytest.mark.parametrize("substep", (False, True))
@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_swc_mhd_kinds_match_jax(dtype, substep):
    """The MHD φ kinds (rank 3, 8 fields; the substep with its aux)."""
    shape = (6, 8, 16)
    rng = np.random.default_rng(3)
    f = (1e-2 * rng.standard_normal((8,) + shape)).astype(dtype)
    w = (1e-3 * rng.standard_normal((8,) + shape)).astype(dtype)
    jp = jmhd.MHDParams()
    tp = tmhd.MHDParams()
    jops = js.derivative_operator_set(3, 6, (0.3, 0.2, 0.1))
    tops = ts.derivative_operator_set(3, 6, (0.3, 0.2, 0.1))
    fp_j = jnp.pad(jnp.asarray(f), ((0, 0),) + ((3, 3),) * 3, mode="wrap")
    fp_t = pad(torch.from_numpy(f), 3, "periodic", spatial_axes=(1, 2, 3))
    assert np.array_equal(fp_t.numpy(), np.asarray(fp_j))
    if substep:
        a, b, dt = jmhd.RK3_ALPHA[1], jmhd.RK3_BETA[1], 0.01
        solver = jmhd.MHDSolver(shape)
        out_j = jax_fused(
            fp_j, jops, solver._substep_phi(a, b, dt), 16,
            aux=jnp.asarray(w), strategy="swc", block=(6, 8, 16),
        )
        out_t = fused_stencil_nd(
            fp_t, tops, tmhd.mhd_substep_device_phi(tp, a, b, dt), 16,
            aux=torch.from_numpy(w), strategy="swc",
        )
    else:
        out_j = jax_fused(
            fp_j, jops, jmhd.mhd_rhs_phi(jp), 8, strategy="swc",
            block=(6, 8, 16),
        )
        out_t = fused_stencil_nd(
            fp_t, tops, tmhd.mhd_rhs_device_phi(tp), 8, strategy="swc",
        )
    assert _rel(out_t.numpy(), out_j) <= TOL[dtype]


@pytest.mark.parametrize("rank", (1, 3))
def test_unroll_and_explicit_block_match_jax(rank):
    fp = _padded(rank, 1, "float64", seed=4)
    ops_t = ts.derivative_operator_set(rank, 4)
    ops_j = js.derivative_operator_set(rank, 4)
    block = (2, 5, 8) if rank == 3 else (10,)
    plan = plan_for_nd(ops_t, fp.shape, 1, block=block, unroll=2,
                       dtype="float64")
    assert plan.unroll == 2
    out_t = fused_stencil_nd(
        torch.from_numpy(fp), ops_t, select_phi("dx"), 1, strategy="swc",
        block=block, unroll=2,
    )
    out_j = jax_fused(
        jnp.asarray(fp), ops_j, lambda d: d["dx"], 1, strategy="swc",
        block=block, unroll=2,
    )
    assert _rel(out_t.numpy(), out_j) <= TOL["float64"]


def test_hwc_depth_matches_jax():
    """hwc applies the op fuse_steps times on a widened pad."""
    fp = _padded(2, 1, "float64", seed=5)
    fp = np.pad(fp, ((0, 0), (2, 2), (2, 2)), mode="wrap")
    ops_t = ts.derivative_operator_set(2, 4, 0.5)
    ops_j = js.derivative_operator_set(2, 4, 0.5)

    def phi(d):
        return d["val"] + 0.01 * (d["dxx"] + d["dyy"])

    out_t = fused_stencil_nd(torch.from_numpy(fp), ops_t, phi, 1,
                             strategy="hwc", fuse_steps=2)
    out_j = jax_fused(jnp.asarray(fp), ops_j, phi, 1, strategy="hwc",
                      fuse_steps=2)
    assert _rel(out_t.numpy(), out_j) <= TOL["float64"]


def test_tap_table_layout():
    ops = ts.derivative_operator_set(2, 4)
    offsets, coeffs, starts = emit.tap_table(ops)
    assert offsets.dtype == torch.int32 and coeffs.dtype == torch.float64
    assert offsets.shape == (ops.taps_per_point, 3)
    assert (offsets[:, 0] == 0).all()  # rank 2 lifted to rank 3
    assert starts.tolist()[0] == 0 and starts.tolist()[-1] == len(coeffs)
    k = 0
    for s, spec in enumerate(ops.ops):
        assert int(starts[s]) == k
        for off, c in zip(spec.offsets, spec.coeffs):
            assert tuple(offsets[k, 1:].tolist()) == off
            assert float(coeffs[k]) == c  # float64, not cast
            k += 1


def test_geometry_layout():
    ops = ts.derivative_operator_set(2, 6)
    plan = plan_for_nd(ops, (8, 22, 70), 8, block=(4, 16), unroll=2)
    g = emit.geometry(plan, [0, 3])
    assert len(g) == emit.GEOM_LEN and g.dtype == np.int32
    # n_f n_out n_aux | interior | padded | radii | tile | u ops taps
    # n_slots | fuse_steps stage_buffers threads segments | members |
    # tc's band-row length (0 off tc) | slots | tiles per step, tc's
    # table words, outputs per thread (depth 1)
    assert (plan.stage_buffers, plan.threads) == (3, 256)
    assert g[:26].tolist() == [
        8, 8, 0, 1, 16, 64, 1, 22, 70, 0, 3, 3, 1, 4, 16, 2,
        ops.n_s, ops.taps_per_point, 2, 1, 3, 256, 1, 1, 0, 0,
    ]
    assert g[26] == 3 and not g[27:41].any()
    assert g[41:].tolist() == [1, 0, plan.outputs_per_thread]
    # On tc the band rows hold 2·r_max + 1 coefficients.
    tc = plan_for_nd(ops, (8, 22, 70), 8, strategy="tc")
    assert emit.geometry(tc, [0])[24] == 7
    # A batched operand's members follow the segments.
    batched = plan_for_nd(ops, (5, 8, 22, 70), 8, block=(4, 16), unroll=2)
    assert emit.geometry(batched, [0, 3])[23] == 5
    # At depth 2 the padded extents widen by 2r per side and the
    # fuse_steps / stage_buffers / threads entries follow the plan; the
    # select kind's walk lifts rank 2 to (Y, 1, X), the walk along Y.
    deep = plan_for_nd(ops, (8, 28, 76), 8, block=(4, 16), fuse_steps=2)
    g = emit.geometry(deep, [0])
    assert deep.temporal_walk
    assert g[3:9].tolist() == [16, 1, 64, 28, 1, 76]
    assert g[19:22].tolist() == [2, deep.stage_buffers, deep.threads]


def test_wrapper_checks_operands():
    ops = ts.derivative_operator_set(3, 6)
    fp = torch.zeros(8, 14, 14, 38)
    rhs = tmhd.mhd_rhs_device_phi(tmhd.MHDParams())
    # The kernels that keep φ's 80 inputs in registers (depth > 1 in f64,
    # and swc_stream in f64) take tiles of at most 256 points; depth 1 on
    # swc (and swc_stream's ring body and the temporal walk in f32) keeps
    # them in shared memory and takes a 512-point tile.
    deep = torch.zeros(8, 14, 20, 44, dtype=torch.float64)
    plan = plan_for_nd(ops, tuple(deep.shape), 8, block=(2, 8, 32),
                       fuse_steps=2, n_slots=10, dtype="float64")
    with pytest.raises(ValueError, match="registers"):
        emit.fused_stencil_swc(deep, ops, rhs, plan)
    # A depth-1 plan made for one φ kind refuses another: its layout
    # follows the operators φ reads.
    plan = plan_for_nd(ops, tuple(fp.shape), 8, block=(2, 8, 32),
                       strategy="swc_stream")
    with pytest.raises(ValueError, match="operator slot"):
        emit.fused_stencil_swc(fp, ops, rhs, plan)
    plan = plan_for_nd(ops, tuple(fp.shape), 8, block=(2, 8, 32),
                       n_slots=10)
    assert emit.fused_stencil_swc(fp, ops, rhs, plan).shape == (8, 8, 8, 32)
    plan = plan_for_nd(ops, tuple(fp.shape), 8, block=(1, 8, 32))
    with pytest.raises(ValueError, match="shape"):
        emit.fused_stencil_swc(fp[:, 1:], ops, rhs, plan)
    with pytest.raises(ValueError, match="dtype"):
        emit.fused_stencil_swc(fp.double(), ops, rhs, plan)
    with pytest.raises(ValueError, match="aux"):
        emit.fused_stencil_swc(fp, ops, rhs, plan, aux=torch.zeros(8, 8, 8, 32))
    with pytest.raises(ValueError, match="DevicePhi"):
        emit.fused_stencil_swc(fp, ops, lambda d: d["val"], plan)
    with pytest.raises(ValueError, match="not in the set"):
        emit.fused_stencil_swc(fp[:1], ts.derivative_operator_set(3, 6),
                               select_phi("lap"),
                               plan_for_nd(ops, (1, 14, 14, 38), 1))


def test_device_phi_validation():
    with pytest.raises(ValueError, match="unknown DevicePhi kind"):
        DevicePhi("curl", (), lambda d: d, ("val",))
    with pytest.raises(ValueError, match="reads operators"):
        DevicePhi("mhd_rhs", (0.0,) * 15, lambda d: d, ("val",))
    phi = select_phi("step")
    assert phi({"step": torch.ones(2)}).tolist() == [1.0, 1.0]
    assert (phi.n_out(3), phi.needs_aux, phi.kind_id) == (3, False, 0)
    sub = tmhd.mhd_substep_device_phi(tmhd.MHDParams(), 0.5, 0.25, 1e-3)
    assert sub.params[-3:] == (0.5, 0.25, 1e-3)
    assert (sub.n_out(8), sub.needs_aux) == (16, True)


def test_cpu_path_counts_no_launch():
    ops = ts.derivative_operator_set(1, 2)
    before = emit.fused_stencil_swc.launches
    out = fused_stencil_nd(torch.ones(1, 10), ops, select_phi("val"), 1,
                           strategy="swc")
    assert out.shape == (1, 8)
    assert emit.fused_stencil_swc.launches == before


def test_not_ported_options_raise(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path))
    ops = ts.derivative_operator_set(2, 2)
    fp = torch.zeros(1, 10, 10)
    # block="auto" (the tuner, ROADMAP A9) resolves: on the CPU by the
    # model, the launch equal to the explicit one.
    fr = torch.randn(1, 10, 10, generator=torch.Generator().manual_seed(2))
    assert torch.equal(
        fused_stencil_nd(fr, ops, select_phi("val"), 1, block="auto"),
        fused_stencil_nd(fr, ops, select_phi("val"), 1))
    # bf16 on the stream kernel (B3c) is ported: the plain version here.
    out = fused_stencil_nd(fp.to(torch.bfloat16), ops, select_phi("val"), 1,
                           strategy="swc_stream")
    assert out.shape == (1, 8, 8) and out.dtype == torch.bfloat16
    # The tensor-core regime (B4) is ported.
    out = fused_stencil_nd(fp, ops, select_phi("val"), 1, strategy="tc")
    assert out.shape == (1, 8, 8)
    # The ensemble batch axis (B5) is ported: a leading member axis.
    out = fused_stencil_nd(fp[None], ops, select_phi("val"), 1)
    assert out.shape == (1, 1, 8, 8)
    # Temporal fusion (B2) is ported: depth 2 consumes 2r of the pad.
    out = fused_stencil_nd(fp, ops, select_phi("val"), 1, fuse_steps=2)
    assert out.shape == (1, 6, 6)
    # Streaming (B3) is ported for ranks 2 and 3; rank 1 names 'swc'.
    out = fused_stencil_nd(fp, ops, select_phi("val"), 1,
                           strategy="swc_stream")
    assert out.shape == (1, 8, 8)
    with pytest.raises(ValueError, match="strategy='swc'"):
        fused_stencil_nd(torch.zeros(1, 10), ts.derivative_operator_set(1, 2),
                         select_phi("val"), 1, strategy="swc_stream")


def test_module_moves_and_guards_tap_table():
    ops = ts.derivative_operator_set(1, 2)
    op = FusedStencilOp(ops, select_phi("dxx"), 1, strategy="swc",
                        device="cpu")
    assert op.tap_coeffs.dtype == torch.float64
    assert {n for n, _ in op.named_buffers()} == {
        "tap_offsets", "tap_coeffs", "tap_starts",
    }
    f = torch.linspace(0, 1, 16, dtype=torch.float64)[None]
    want = ref.fused_stencil(pad(f, 1, spatial_axes=(1,)), ops,
                             lambda d: d["dxx"])
    assert torch.equal(op(f), want)
    op.to(torch.float32)  # a dtype move would round the coefficients
    with pytest.raises(ValueError, match="float64"):
        op(f)


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("rank", (1, 2, 3))
def test_kernel_select_matches_plain_on_card(cuda_device, rank, dtype):
    fp = torch.from_numpy(_padded(rank, 2, dtype)).to(cuda_device)
    ops = ts.derivative_operator_set(rank, 4, 0.5)
    before = emit.fused_stencil_swc.launches
    got = fused_stencil_nd(fp, ops, select_phi("dxx"), 2, strategy="swc")
    assert emit.fused_stencil_swc.launches == before + 1
    want = ref.fused_stencil(fp, ops, lambda d: d["dxx"])
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_kernel_mhd_substep_matches_plain_on_card(cuda_device, dtype):
    solver = tmhd.MHDSolver((16, 24, 32), strategy="swc", device=cuda_device)
    f = solver.init_smooth(0, amplitude=1e-2, dtype=dtype)
    fp = pad(f, 3, "periodic", spatial_axes=(1, 2, 3))
    w = 1e-3 * torch.ones_like(f)
    phi = tmhd.mhd_substep_device_phi(solver.params, -5 / 9, 15 / 16, 1e-2)
    got = fused_stencil_nd(fp, solver.operator_set, phi, 16, aux=w,
                           strategy="swc", block=solver.block)
    want = ref.fused_stencil(fp, solver.operator_set, phi.torch_fn, aux=w)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL[dtype]
