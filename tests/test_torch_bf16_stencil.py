"""bfloat16 in the fused-stencil kernels' plans against the JAX package:
the temporal kernel (``swc`` at depth > 1, ROADMAP B2c), the stream
kernel (``swc_stream`` at every depth, B3c) and the MHD φ in bf16 on
every strategy and RK3 form (B4b), plus the planner's bf16 plans, their
shared bytes held to the auditor's mirror of the kernels' layouts, and
the tuner's model of them.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
in interpret mode. On the CPU the port's wrapper takes its plain
version, which rounds every product and sum of a tap loop, and every
operation of φ, to bf16 as the reference's elementwise bf16 arithmetic
does. The same bf16 inputs (made from a seed with numpy, rounded once
by JAX) go to both packages, and bf16 is compared with bf16, never with
f32: the reference's own bf16 RHS lies 8.45e-3 (random fields) to
1.52e-2 (smooth fields) of max |f32| from its f32 RHS, so the 2e-2 limit
would leave little room over an f32 comparison.

Tolerances: diffusion 2e-2 relative to the largest |value|, the
reference's bf16 limit (``tests/test_tc.py:66``). The MHD RK3 step on
``swc`` and ``swc_stream`` equals the reference's bit for bit; on
``tc`` the reference's contractions sum in XLA's own order in f32
before each operator's one rounding to bf16, which moves some sums by
one bf16 ulp, so ``tc`` is held to 2e-2.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.physics import diffusion as jd  # noqa: E402
from repro.physics import mhd as jm  # noqa: E402
from repro_torch.analysis.bounds import audit_plan  # noqa: E402
from repro_torch.convert import fields_from_numpy  # noqa: E402
from repro_torch.core import stencil as ts  # noqa: E402
from repro_torch.kernels import emit  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.physics import diffusion as td  # noqa: E402
from repro_torch.physics import mhd as tm  # noqa: E402
from repro_torch.tuning import costmodel  # noqa: E402

TOL = 2e-2
CPU = "cpu"
# Small interiors, not tile-aligned; a stream extent that holds the
# carried halo (2 r S = 12 planes at order 4, depth 3) plus a chunk.
DIFFUSION = {1: (96,), 2: (24, 40), 3: (20, 12, 40)}
MHD_SHAPE = (16, 16, 16)
MHD_FORMS = (
    ("swc", {}), ("swc_stream", {}), ("tc", {}),
    ("swc", {"fuse_rk_axpy": True}), ("tc", {"fuse_rk_axpy": True}),
    ("swc", {"fuse_rk_pairs": True}), ("tc", {"fuse_rk_pairs": True}),
)


def _rel(got: torch.Tensor, want) -> float:
    a = got.float().numpy().astype(np.float64)
    b = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _to_port(x) -> torch.Tensor:
    """A JAX bf16 array as a port tensor, bit for bit."""
    return fields_from_numpy(np.asarray(x), device=CPU)


@pytest.mark.parametrize("strategy,rank,depth", [
    ("swc", rank, depth) for rank in (1, 2, 3) for depth in (2, 3)
] + [
    ("swc_stream", rank, depth) for rank in (2, 3) for depth in (1, 2, 3)
])
def test_bf16_diffusion_matches_jax(strategy, rank, depth):
    """One fused op of ``depth`` forward-Euler steps (order 4) through
    the port's ``FusedStencilOp`` and the reference's, on the same bf16
    field."""
    shape = DIFFUSION[rank]
    rng = np.random.default_rng(10 * rank + depth)
    f = jnp.asarray(rng.uniform(-1.0, 1.0, (1,) + shape), jnp.bfloat16)
    want = jd.DiffusionProblem(shape, accuracy=4).step_op(
        strategy, fuse_steps=depth)(f)
    got = td.DiffusionProblem(shape, accuracy=4).step_op(
        strategy, fuse_steps=depth, device=CPU)(_to_port(f))
    assert got.dtype == torch.bfloat16 and got.shape == (1,) + shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("init", ("fields", "smooth"))
@pytest.mark.parametrize("strategy,form", MHD_FORMS)
def test_bf16_mhd_step_matches_jax(strategy, form, init):
    """One RK3 step of ``MHDSolver`` in bf16 at 16³, each strategy and
    form the reference takes, from its benchmark init and its smooth
    init: bit for bit on ``swc`` and ``swc_stream``, within 2e-2 on
    ``tc`` (module docstring)."""
    jsolver = jm.MHDSolver(MHD_SHAPE, strategy=strategy, **form)
    f = (jsolver.init_fields(dtype=jnp.bfloat16) if init == "fields"
         else jsolver.init_smooth(amplitude=1e-2, dtype=jnp.bfloat16))
    want = jsolver.step(f, 1e-3)
    tsolver = tm.MHDSolver(MHD_SHAPE, strategy=strategy, device=CPU, **form)
    got = tsolver.step(_to_port(f), 1e-3)
    assert got.dtype == torch.bfloat16 and got.shape == (8,) + MHD_SHAPE
    if strategy == "tc":
        assert _rel(got, want) <= TOL
    else:
        assert np.array_equal(got.float().numpy(),
                              np.asarray(jnp.asarray(want, jnp.float32)))


def _bf16_plans():
    """(label, plan, ops) of each new bf16 launch: the temporal walk
    (ranks 2, 3, a ragged row of 41 values) and the one-tile body (rank
    1), the stream ring and walk, and the MHD φ on B1, B3's ring, B4 and
    both walks' pair."""
    diff = {r: ts.derivative_operator_set(r, 6, 0.3) for r in (1, 2, 3)}
    mhd = ts.derivative_operator_set(3, 6, 0.3)
    bf = "bfloat16"
    out = []
    for depth in (2, 3):
        for rank, shape in ((1, (4096,)), (2, (512, 384)),
                            (3, (64, 96, 128)), (3, (48, 18, 41 - 6 * depth))):
            padded = (1,) + tuple(n + 6 * depth for n in shape)
            out.append((f"swc S={depth} {shape}", tplan.plan_stencil(
                diff[rank], padded, 1, dtype=bf, fuse_steps=depth), diff[rank]))
    for depth in (1, 2, 3):
        for rank, shape in ((2, (512, 400)), (3, (64, 96, 120))):
            padded = (1,) + tuple(n + 6 * depth for n in shape)
            out.append((f"swc_stream S={depth} {shape}", tplan.plan_stencil(
                diff[rank], padded, 1, strategy="swc_stream", dtype=bf,
                fuse_steps=depth), diff[rank]))
    shape = (64, 64, 64)
    pad1 = (8,) + tuple(n + 6 for n in shape)
    for strategy, n_out, aux in (("swc", 8, 0), ("swc", 16, 8),
                                 ("swc_stream", 8, 0), ("tc", 8, 0),
                                 ("tc", 16, 8)):
        out.append((f"{strategy} MHD n_out={n_out}", tplan.plan_stencil(
            mhd, pad1, n_out, strategy=strategy, dtype=bf, n_aux=aux,
            n_slots=10, block=(1, 8, 32) if strategy == "swc_stream" else None,
            max_threads=256), mhd))
    pad2 = (8,) + tuple(n + 12 for n in shape)
    for strategy in ("swc", "tc"):
        out.append((f"{strategy} MHD pair", tplan.plan_stencil(
            mhd, pad2, 16, strategy=strategy, dtype=bf, n_aux=8, n_slots=10,
            fuse_steps=2, max_threads=256), mhd))
    return out


def test_bf16_plans_build_and_their_bytes_are_the_mirrors():
    """The planner builds every new bf16 plan on the body it names (the
    walks, the stream ring, the depth-1 kernels); each plan's shared
    bytes equal the auditor's mirror of the kernel's layout, with no
    finding, as the f32 plans' do."""
    seen = set()
    for label, plan, ops in _bf16_plans():
        assert plan.dtype == "bfloat16", label
        res = audit_plan(plan, ops)
        assert res.findings == [], (label, res.findings)
        assert res.measured_smem == plan.smem_bytes, label
        assert plan.smem_bytes <= tplan.SMEM_PER_BLOCK, label
        seen.add(res.body)
        if plan.strategy == "swc" and plan.fuse_steps > 1:
            assert plan.temporal_walk == (plan.rank > 1), label
        if plan.strategy == "swc_stream":
            assert plan.stream_walk == (plan.fuse_steps > 1), label
            assert plan.stream_depth1 == (plan.fuse_steps == 1), label
        if plan.n_slots > 1 and plan.fuse_steps > 1:
            assert plan.walk, label
        assert emit.kernel_name(plan)
    assert seen == {"temporal_walk_body", "temporal_body", "stream_body",
                    "swc_body", "tc_body", "tc_walk_body"}


def test_bf16_walk_rings_hold_two_byte_values():
    """The bf16 walk keeps f32's tiles with rings of 2-byte values, rows
    congruent to the padded rows modulo 16 bytes (8 values); the tc
    walk's MHD φ inputs are f32 sums for patches of 16 x 8 points."""
    ops = ts.derivative_operator_set(3, 6, 0.3)
    padded = (1, 76, 76, 76)
    f32 = tplan.plan_stencil(ops, padded, 1, fuse_steps=2)
    bf = tplan.plan_stencil(ops, padded, 1, fuse_steps=2, dtype="bfloat16")
    assert bf.block == f32.block and bf.temporal_walk
    ring16, ring32 = bf.walk_ring.inp, f32.walk_ring.inp
    assert ring16.pitch % 8 == padded[-1] % 8
    assert ring16.ring_bytes < ring32.ring_bytes
    mhd = tplan.plan_stencil(ops, (8, 76, 76, 76), 16, strategy="tc",
                             dtype="bfloat16", n_aux=8, n_slots=10,
                             fuse_steps=2, max_threads=256)
    base = tplan.tc_walk_smem_bytes(mhd.walk_ring,
                                    table_words=mhd.tc_table_words)
    assert mhd.smem_bytes - base == 4 * 10 * 8 * 2 * 16 * 8


def test_auto_sees_bf16_temporal_and_stream_plans():
    """The tuner's candidates hold the bf16 plans the planner now builds
    (swc at depth > 1, swc_stream at every depth), and its model counts
    2 bytes a value: a bytes-bound bf16 launch scores below the same
    launch in f32."""
    ops = td.DiffusionProblem((64, 64, 64), accuracy=6).step_op(
        "hwc", device=CPU).ops
    cands = costmodel.enumerate_candidates_nd(
        ops, (64, 64, 64), 1, 1, "bfloat16",
        strategies=("swc", "swc_stream"), fuse_steps_options=(1, 2, 3))
    kinds = {(c.strategy, c.fuse_steps) for c in cands}
    assert {("swc", 2), ("swc", 3), ("swc_stream", 1), ("swc_stream", 2),
            ("swc_stream", 3)} <= kinds
    padded = (1,) + (64 + 6,) * 3
    plan = tplan.plan_stencil(ops, padded, 1, strategy="swc_stream",
                              dtype="bfloat16")
    twin = dataclasses.replace(plan, dtype="float32")
    assert costmodel.plan_score(plan, ops) < costmodel.plan_score(twin, ops)
