"""``strategy="auto"``, ``block="auto"`` and ``fuse_steps="auto"`` in the
port, held against the JAX package's ``"auto"`` on the same numpy
inputs: ``FusedStencilOp``, ``DiffusionProblem`` and ``MHDSolver`` at
ranks 1-3, f32 within 1e-5 and f64 within 1e-12 (relative to the
largest |value|), small grids. On the CPU the port resolves by its
Hopper model alone; the reference runs under ``jax.jit``, where it too
takes its model's winner (no interpret-mode timing). The two models
differ, so where the depth is tuned the reference is pinned to the
depth the port resolved. Also: the record round trip (a warm hit
reproduces the decision, in this process and a fresh one), a persisted
``swc_stream`` winner replayed, the validation surface, a pinned depth,
and the MHD RHS at depth 1.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import fusion as jfusion  # noqa: E402
from repro.core import stencil as js  # noqa: E402
from repro.physics import diffusion as jd  # noqa: E402
from repro.physics import mhd as jm  # noqa: E402
from repro_torch.core.fusion import FusedStencilOp, integrate  # noqa: E402
from repro_torch.core.stencil import derivative_operator_set  # noqa: E402
from repro_torch.kernels.phi import select_phi  # noqa: E402
from repro_torch.kernels.plan import plan_from_record  # noqa: E402
from repro_torch.physics import diffusion as td  # noqa: E402
from repro_torch.physics import mhd as tm  # noqa: E402
from repro_torch.tuning import (  # noqa: E402
    SCHEMA_VERSION,
    TuningCache,
    TuningRecord,
    TuningSession,
    enumerate_cross_strategy_nd,
    fused_nd_key,
    lookup_fused_nd,
)
from repro_torch.tuning import session as sess_mod  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
CPU = "cpu"
TOL = {"float32": 1e-5, "float64": 1e-12}
SHAPES = {1: (1 << 10,), 2: (32, 64), 3: (16, 12, 16)}


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """Both packages' caches in a fresh directory each."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax"))
    return tmp_path / "torch"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _field(shape, dtype, seed=1):
    f = jd.DiffusionProblem(shape).init_field(seed=seed)
    return np.array(f, dtype=dtype)


# --- outputs against the reference's "auto" -------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_diffusion_auto_matches_the_reference_auto(cache_dir, ndim, dtype):
    """DiffusionProblem.step_op("auto", fuse_steps="auto") resolves to a
    concrete regime (never ``tc`` in f64, never ``swc_stream`` at rank
    1) and equals the reference's ``"auto"`` at that depth."""
    shape = SHAPES[ndim]
    f = _field(shape, dtype)
    tp = td.DiffusionProblem(shape)
    op = tp.step_op("auto", fuse_steps="auto", device=CPU)
    assert op.block == "auto"  # the search owns the block
    rop = op.resolved(torch.from_numpy(f))
    assert rop.strategy in ("hwc", "swc", "swc_stream", "tc")
    assert isinstance(rop.block, tuple) and len(rop.block) == ndim
    if dtype == "float64":
        assert rop.strategy != "tc"
    if ndim == 1:
        assert rop.strategy != "swc_stream"
    got = op(torch.from_numpy(f))
    jop = jd.DiffusionProblem(shape).step_op("auto",
                                             fuse_steps=rop.fuse_steps)
    want = jax.jit(jop)(jnp.asarray(f))
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("strategy,dtype", [
    ("swc", "float32"), ("swc", "float64"), ("tc", "float32"),
])
def test_fused_op_block_and_depth_auto_match_the_reference(
        cache_dir, ndim, dtype, strategy):
    """FusedStencilOp on a fixed strategy with ``block="auto"`` (depth 2)
    and ``fuse_steps="auto"``: two fields, φ selecting one operator of a
    derivative set, against the reference's ``block="auto"`` ops (``tc``
    in float32: its rule)."""
    shape = SHAPES[ndim][-ndim:]
    rng = np.random.default_rng(ndim)
    f = rng.standard_normal((2,) + shape).astype(dtype)
    t_ops = derivative_operator_set(ndim, 4, spacing=0.5)
    j_ops = js.derivative_operator_set(ndim, 4, spacing=0.5)
    name = "dxx"
    op = FusedStencilOp(t_ops, select_phi(name), 2, strategy=strategy,
                        block="auto", fuse_steps="auto", device=CPU)
    rop = op.resolved(torch.from_numpy(f))
    got = op(torch.from_numpy(f))
    jop = jfusion.FusedStencilOp(j_ops, lambda d: d[name], 2,
                                 strategy=strategy, block="auto",
                                 fuse_steps=rop.fuse_steps)
    assert _rel(got, jax.jit(jop)(jnp.asarray(f))) <= TOL[dtype]
    got2 = FusedStencilOp(t_ops, select_phi(name), 2, strategy=strategy,
                          block="auto", fuse_steps=2, device=CPU)(
        torch.from_numpy(f))
    jop2 = jfusion.FusedStencilOp(j_ops, lambda d: d[name], 2,
                                  strategy=strategy, block="auto",
                                  fuse_steps=2)
    assert _rel(got2, jax.jit(jop2)(jnp.asarray(f))) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mhd_auto_matches_the_reference_auto(cache_dir, dtype):
    """MHDSolver(strategy="auto"): the RHS (depth 1) and a fused-axpy
    RK3 step (aux carries: no ``swc_stream``) equal the reference's
    ``"auto"`` solver's."""
    n = 8
    js_ = jm.MHDSolver((n, n, n), strategy="auto", accuracy=2)
    ts_ = tm.MHDSolver((n, n, n), strategy="auto", accuracy=2, device=CPU)
    assert ts_.op_block == "auto" == js_.op_block
    f = np.array(js_.init_smooth(seed=0, amplitude=1e-3), dtype=dtype)
    got = ts_.rhs(torch.from_numpy(f))
    want = jax.jit(js_.rhs)(jnp.asarray(f))
    assert _rel(got, want) <= TOL[dtype]
    ja = jm.MHDSolver((n, n, n), strategy="auto", accuracy=2,
                      fuse_rk_axpy=True)
    ta = tm.MHDSolver((n, n, n), strategy="auto", accuracy=2,
                      fuse_rk_axpy=True, device=CPU)
    got = ta.step(torch.from_numpy(f), 1e-3)
    want = jax.jit(lambda x: ja.step(x, 1e-3))(jnp.asarray(f))
    assert _rel(got, want) <= TOL[dtype]


def test_auto_mhd_rhs_depth_stays_one(cache_dir):
    """The RHS maps the fields to themselves but is not a time step: its
    search keeps depth 1 (keyed without a depth suffix), and the output
    matches hwc."""
    n = 8
    base = tm.MHDSolver((n, n, n), strategy="hwc", accuracy=2, device=CPU)
    auto = tm.MHDSolver((n, n, n), strategy="auto", accuracy=2, device=CPU)
    f = base.init_smooth(seed=0, amplitude=1e-3, dtype="float64")
    rop = auto.rhs_op().resolved(f)
    assert rop.fuse_steps == 1
    assert _rel(auto.rhs(f), base.rhs(f)) < 1e-12
    assert any("|auto:sauto:o2|" in k for k in TuningCache().items())


# --- the record round trip -------------------------------------------------------


def test_auto_round_trips_through_the_cache(cache_dir):
    """Resolve → record → warm hit: the warm resolution is the same
    (strategy, block, depth), nothing is enumerated or measured, the
    output is the same bit for bit; the plan the record reconstructs is
    the plan of the resolved op; a fresh process replays it."""
    p = td.DiffusionProblem((64, 128))
    f0 = p.init_field(seed=3, device=CPU)
    op = p.step_op("auto", fuse_steps="auto", device=CPU)
    r1 = op.resolved(f0)
    out1 = r1(f0)
    rec = lookup_fused_nd(f0, op.ops, 1, "auto", fuse_steps="auto")
    assert rec is not None and rec.source == "model"
    assert rec.schema == SCHEMA_VERSION
    assert rec.strategy_resolved == r1.strategy
    assert rec.stream == (r1.strategy == "swc_stream")
    before = sess_mod.MEASURE_COUNT
    r2 = p.step_op("auto", fuse_steps="auto", device=CPU).resolved(f0)
    assert sess_mod.MEASURE_COUNT == before
    assert (r2.strategy, r2.block, r2.fuse_steps) == (
        r1.strategy, r1.block, r1.fuse_steps)
    assert torch.equal(out1, r2(f0))
    plan = plan_from_record(op.ops, tuple(f0.shape), 1, rec)
    if r1.strategy == "hwc":
        assert plan is None
    else:
        assert (plan.strategy, plan.block, plan.fuse_steps) == (
            r1.strategy, r1.block, r1.fuse_steps)
    code = """
from repro_torch.physics.diffusion import DiffusionProblem
from repro_torch.tuning import TuningCache, session
p = DiffusionProblem((64, 128))
f0 = p.init_field(seed=3, device="cpu")
before = TuningCache().items()
rop = p.step_op("auto", fuse_steps="auto", device="cpu").resolved(f0)
assert session.MEASURE_COUNT == 0 and TuningCache().items() == before
print(f"REPLAYED {rop.strategy} {rop.block} {rop.fuse_steps}")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env)
    assert res.returncode == 0, res.stderr
    assert (f"REPLAYED {r1.strategy} {r1.block} {r1.fuse_steps}"
            in res.stdout)


def test_warm_hit_reproduces_a_stream_winner(cache_dir):
    """A persisted ``swc_stream`` winner (what the card measured) is
    replayed: the op resolves to it at the recorded block and depth
    without a new record, and runs as a fused stream."""
    p = td.DiffusionProblem((64, 128))
    f0 = p.init_field(seed=4, device=CPU)
    key = fused_nd_key((64, 128), (3, 3), 1, 1, "float32", "auto",
                       backend="cpu", fuse_steps="auto")
    assert ":sauto" in key.strategy and ":fauto" in key.strategy
    TuningCache().put(key, TuningRecord(
        block=(4, 128), timings_us={"4x128@f2:s": 5.0}, source="measured",
        fuse_steps=2, stream=True, strategy_resolved="swc_stream",
    ))
    rop = p.step_op("auto", fuse_steps="auto", device=CPU).resolved(f0)
    assert (rop.strategy, rop.block, rop.fuse_steps) == (
        "swc_stream", (4, 128), 2)
    assert len(TuningCache().items()) == 1
    base = integrate(p.step_op("hwc", device=CPU), f0, 2)
    assert _rel(rop(f0), base) <= 1e-5


def test_stream_flag_persisted_on_fauto_records(cache_dir):
    import json

    p = td.DiffusionProblem((64, 128))
    f0 = p.init_field(seed=5, device=CPU)
    p.step_op("swc_stream", block="auto", fuse_steps="auto",
              device=CPU)(f0)
    raw = json.loads((cache_dir / "cache.json").read_text())
    recs = [r for k, r in raw["records"].items()
            if "swc_stream:sy:fauto" in k]
    assert recs and all(r["stream"] is True for r in recs)
    assert all(r["strategy_resolved"] == "swc_stream" for r in recs)


def test_integrate_remainder_resolves_its_own_depth(cache_dir):
    """integrate() resolves once, up front; a remainder at depth rem
    tunes its own block (its own key) instead of reusing the full
    depth's, and the step count stays exact."""
    p = td.DiffusionProblem((32, 64))
    f0 = p.init_field(seed=6, device=CPU)
    op = p.step_op("swc", block="auto", fuse_steps="auto", device=CPU)
    depth = op.resolved(f0).fuse_steps
    n = depth + 1 if depth > 1 else 3
    out = integrate(op, f0, n)
    want = integrate(p.step_op("hwc", device=CPU), f0, n)
    assert _rel(out, want) <= 1e-5
    keys = list(TuningCache().items())
    assert any(":fauto|" in k for k in keys)


# --- validation -----------------------------------------------------------------


def test_auto_validation_surface():
    """strategy='auto' owns the block (None read as 'auto', an explicit
    tile refused); apply_padded needs a resolved op; fuse_steps='auto'
    composes with strategy='auto' and needs block='auto' elsewhere; a φ
    sequence cannot have a tuned depth."""
    ops = derivative_operator_set(2, 4, spacing=0.5)
    op = FusedStencilOp(ops, select_phi("val"), 1, strategy="auto",
                        device=CPU)
    assert op.block == "auto" and op.needs_resolution
    with pytest.raises(ValueError, match="block='auto'"):
        FusedStencilOp(ops, select_phi("val"), 1, strategy="auto",
                       block=(8, 16), device=CPU)
    with pytest.raises(ValueError, match="resolve"):
        op.apply_padded(torch.zeros((1, 20, 20)))
    assert FusedStencilOp(ops, select_phi("val"), 1, strategy="auto",
                          fuse_steps="auto", device=CPU).needs_resolution
    with pytest.raises(ValueError, match="block='auto'"):
        FusedStencilOp(ops, select_phi("val"), 1, strategy="swc",
                       fuse_steps="auto", device=CPU)
    with pytest.raises(ValueError, match="'auto'"):
        FusedStencilOp(ops, select_phi("val"), 1, strategy="swc",
                       block="tuned", device=CPU)
    with pytest.raises(ValueError, match="pins the fusion depth"):
        FusedStencilOp(ops, (select_phi("val"),) * 2, 1, strategy="auto",
                       fuse_steps="auto", device=CPU)
    with pytest.raises(ValueError, match="periodic"):
        FusedStencilOp(ops, select_phi("val"), 1, strategy="auto",
                       fuse_steps="auto", boundary_mode="dirichlet",
                       device=CPU)


def test_auto_pinned_depth_on_non_selfmap_raises(cache_dir):
    ops = derivative_operator_set(2, 4, spacing=0.5)
    op = FusedStencilOp(ops, lambda d: d["val"][:1], 1, strategy="auto",
                        fuse_steps=3, device=CPU)
    with pytest.raises(ValueError, match="self-map"):
        op.resolved(torch.zeros((2, 16, 32)))


def test_auto_with_fixed_depth_pins_search(cache_dir):
    p = td.DiffusionProblem((32, 64))
    f0 = p.init_field(seed=8, device=CPU)
    rop = p.step_op("auto", fuse_steps=2, device=CPU).resolved(f0)
    assert rop.fuse_steps == 2
    assert any("auto:sauto:f2|" in k for k in TuningCache().items())


def test_a_bare_callable_resolves_to_the_plain_version(cache_dir):
    """The kernels run only a DevicePhi: with a bare callable φ the
    cross-strategy space is the hwc baseline alone."""
    ops = derivative_operator_set(2, 4, spacing=0.5)
    f = torch.randn(1, 16, 32, generator=torch.Generator().manual_seed(3))
    op = FusedStencilOp(ops, lambda d: d["dxx"] + d["val"], 1,
                        strategy="auto", device=CPU)
    assert op.resolved(f).strategy == "hwc"
    explicit = FusedStencilOp(ops, lambda d: d["dxx"] + d["val"], 1,
                              device=CPU)
    assert torch.equal(op(f), explicit(f))


def test_boundary_weights_and_with_depth_on_the_resolved_op(cache_dir):
    p = td.DiffusionProblem((32, 64))
    f0 = p.init_field(seed=9, device=CPU)
    rop = p.step_op("auto", device=CPU).resolved(f0)
    deeper = rop.with_depth(2)
    assert deeper.strategy == rop.strategy and deeper.fuse_steps == 2
    want = integrate(p.step_op("hwc", device=CPU), f0, 2)
    assert _rel(deeper(f0), want) <= 1e-5
    ops = derivative_operator_set(2, 4, spacing=0.5)
    f = torch.randn(1, 16, 32, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    bw = FusedStencilOp(ops, select_phi("dxx"), 1, strategy="auto",
                        boundary_mode="dirichlet", boundary_weights=True,
                        device=CPU)
    plain = FusedStencilOp(ops, select_phi("dxx"), 1,
                           boundary_mode="dirichlet", boundary_weights=True,
                           device=CPU)
    assert bw.resolved(f).boundary_weights
    assert _rel(bw(f), plain(f)) <= 1e-12


def test_measured_pool_holds_hwc_and_every_default(cache_dir):
    """With a measure (the card's path, injected here), the cross-
    strategy search times the model's top k, the hwc baseline and the
    planner's tile of every strategy and depth."""
    ops = td.DiffusionProblem((64, 128)).step_op("hwc", device=CPU).ops
    cands = enumerate_cross_strategy_nd(ops, (64, 128), 1, 1,
                                        fuse_steps_options=(1, 2),
                                        operators=("step",))
    key = fused_nd_key((64, 128), (3, 3), 1, 1, "float32", "auto",
                       backend="cpu", fuse_steps="auto")
    timed = []
    sess = TuningSession(top_k=2)
    rec = sess.tune(key, cands, lambda c: timed.append(c) or 1.0,
                    pinned=lambda c: c.strategy == "hwc" or c.default)
    labels = set(rec.timings_us)
    assert "hwc" in labels and len(timed) == len(labels)
    defaults = [c for c in cands if c.default]
    assert len(defaults) == 6  # swc, swc_stream, tc at depths 1 and 2
    assert all(c in timed for c in defaults)


def test_block_auto_resolves_once_per_operand(cache_dir, monkeypatch):
    """block="auto" on a fixed strategy resolves in ``resolved`` once for
    an operand; later calls (a served batch, each ``integrate`` step)
    take the concrete op by lookup, with no planner call, and equal the
    explicit launch at the resolved tile."""
    calls = []
    real = sess_mod.auto_block_nd
    monkeypatch.setattr(sess_mod, "auto_block_nd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ops = derivative_operator_set(2, 4, spacing=0.5)
    op = FusedStencilOp(ops, select_phi("val"), 1, strategy="swc",
                        block="auto", device=CPU)
    f = torch.randn((1, 32, 64), generator=torch.Generator().manual_seed(5))
    assert op.needs_resolution
    first, again = op(f), integrate(op, f, 3)
    assert len(calls) == 1
    rop = op.resolved(f)
    assert not rop.needs_resolution and len(calls) == 1
    explicit = FusedStencilOp(ops, select_phi("val"), 1, strategy="swc",
                              block=rop.block, device=CPU)
    assert torch.equal(first, explicit(f))
    assert torch.equal(again, integrate(explicit, f, 3))
