"""The port's physics (``repro_torch.physics``) against the JAX package on
the CPU: diffusion ``simulate`` at ranks 1-3, the Fourier-mode decay,
the MHD RHS and RK3 step (plain and fused axpy), the inits (bit-equal
for one seed) and the CFL step; plus ``repro_torch.convert`` carrying
the reference's state across.

Tolerances: f64 1e-12, f32 1e-5 relative to the largest |value|.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import stencil as js  # noqa: E402
from repro.physics import diffusion as jd  # noqa: E402
from repro.physics import mhd as jm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.fusion import FusedStencilOp, integrate  # noqa: E402
from repro_torch.core.stencil import derivative_operator_set  # noqa: E402
from repro_torch.kernels import emit  # noqa: E402
from repro_torch.physics import diffusion as td  # noqa: E402
from repro_torch.physics import mhd as tm  # noqa: E402

TOL = {"float32": 1e-5, "float64": 1e-12}
CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("shape", ((64,), (16, 24), (8, 12, 16)))
def test_diffusion_simulate_matches_jax(shape, dtype):
    jp, tp = jd.DiffusionProblem(shape), td.DiffusionProblem(shape)
    f0 = np.asarray(jp.init_field(seed=7), dtype=dtype)
    want = jd.simulate(jp, jnp.asarray(f0), 6, strategy="swc")
    got = td.simulate(tp, f0, 6, strategy="swc", device=CPU)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got.numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("shape", ((32,), (12, 16)))
def test_diffusion_hwc_depth_with_remainder_matches_jax(shape):
    jp, tp = jd.DiffusionProblem(shape), td.DiffusionProblem(shape)
    f0 = jp.fourier_mode((2,) * len(shape))
    want = jd.simulate(jp, f0, 7, strategy="hwc", fuse_steps=3)
    got = td.simulate(tp, np.asarray(f0), 7, strategy="hwc", fuse_steps=3,
                      device=CPU)
    assert _rel(got.numpy(), want) <= TOL["float64"]


def test_diffusion_init_and_modes_bit_equal():
    jp, tp = jd.DiffusionProblem((6, 10)), td.DiffusionProblem((6, 10))
    assert np.array_equal(
        tp.init_field(3, device=CPU).numpy(), np.asarray(jp.init_field(3))
    )
    assert np.array_equal(
        tp.fourier_mode((1, 2), device=CPU).numpy(),
        np.asarray(jp.fourier_mode((1, 2))),
    )
    assert (tp.dt, tp.spacing, tp.radius) == (jp.dt, jp.spacing, jp.radius)


@pytest.mark.parametrize(
    "shape,k", [((64,), (3,)), ((32, 32), (2, 1)), ((16, 16, 32), (1, 2, 1))]
)
def test_diffusion_fourier_mode_decay(shape, k):
    """A Fourier mode is an eigenvector of the merged stencil: the swc
    path must decay as λ^n to fp precision, and near exp(-α|k|²t)."""
    p = td.DiffusionProblem(shape, accuracy=6, safety=0.05)
    f0 = p.fourier_mode(k, device=CPU)
    n = 40
    out = td.simulate(p, f0, n, strategy="swc", device=CPU)
    spec = p.merged_stencil()
    lam = sum(
        c * np.cos(sum(ki * oi * hi for ki, oi, hi in zip(k, o, p.spacing)))
        for o, c in zip(spec.offsets, spec.coeffs)
    )
    decay = float(out.norm() / f0.norm())
    assert abs(decay - lam**n) < 1e-10
    ana = p.analytic_decay(k, n * p.dt)
    assert abs(decay - ana) / ana < 2e-3


def _smooth_pair(n=16, dtype="float64", seed=0, amp=1e-2):
    js_ = jm.MHDSolver((n, n, n), strategy="hwc")
    ts_ = tm.MHDSolver((n, n, n), strategy="swc", device=CPU)
    f = np.array(js_.init_smooth(seed, amplitude=amp), dtype=dtype)
    return js_, ts_, f


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_mhd_rhs_matches_jax_swc(dtype):
    _, ts_, f = _smooth_pair(dtype=dtype)
    jswc = jm.MHDSolver((16,) * 3, strategy="swc", block=(8, 8, 16))
    want = jswc.rhs(jnp.asarray(f))
    got = ts_.rhs(torch.from_numpy(f))
    assert _rel(got.numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("fuse_rk_axpy", (False, True))
@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_mhd_step_matches_jax(dtype, fuse_rk_axpy):
    js_, _, f = _smooth_pair(dtype=dtype, seed=1)
    jsol = dataclasses.replace(js_, fuse_rk_axpy=fuse_rk_axpy)
    tsol = tm.MHDSolver((16,) * 3, strategy="swc", fuse_rk_axpy=fuse_rk_axpy,
                        device=CPU)
    dt = float(jsol.cfl_dt(jnp.asarray(f)))
    want = jsol.step(jnp.asarray(f), dt)
    got = tsol.step(torch.from_numpy(f), dt)
    assert _rel(got.numpy(), want) <= TOL[dtype]


def test_mhd_rk_forms_agree_and_simulate_is_stable():
    _, ts_, f = _smooth_pair(seed=2, amp=1e-3)
    f = torch.from_numpy(f)
    dt = float(ts_.cfl_dt(f))
    a = ts_.step(f, dt)
    b = dataclasses.replace(ts_, fuse_rk_axpy=True).step(f, dt)
    assert float((a - b).abs().max()) <= 1e-15
    out = ts_.simulate(f, 5, dt)
    assert bool(torch.isfinite(out).all())
    assert float(out.abs().max()) < 10 * float(f.abs().max()) + 1.0


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_mhd_inits_bit_equal_and_cfl_matches(dtype):
    shape = (6, 8, 10)
    js_ = jm.MHDSolver(shape)
    ts_ = tm.MHDSolver(shape, device=CPU)
    jf = js_.init_fields(5, dtype=getattr(jnp, dtype))
    tf = ts_.init_fields(5, dtype=dtype)
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    js_smooth = js_.init_smooth(4, dtype=getattr(jnp, dtype))
    ts_smooth = ts_.init_smooth(4, dtype=dtype)
    assert np.array_equal(ts_smooth.numpy(), np.asarray(js_smooth))
    for f_t, f_j in ((tf, jf), (ts_smooth, js_smooth)):
        rel = abs(float(ts_.cfl_dt(f_t)) / float(js_.cfl_dt(f_j)) - 1.0)
        assert rel <= (1e-6 if dtype == "float32" else 1e-14)


def test_mhd_equilibrium_and_guards():
    solver = tm.MHDSolver((8, 8, 8), strategy="swc", device=CPU)
    assert float(solver.rhs(torch.zeros(8, 8, 8, 8)).abs().max()) < 1e-12
    with pytest.raises(ValueError, match="fields"):
        solver.rhs(torch.zeros(8, 8, 8, 6))
    # fuse_rk_pairs (B2) is ported: it runs, and keeps the equilibrium.
    pairs = tm.MHDSolver((8, 8, 8), strategy="swc", fuse_rk_pairs=True,
                         device=CPU)
    assert float(pairs.step(torch.zeros(8, 8, 8, 8), 1e-3).abs().max()) < 1e-12
    assert len(tm.MHDParams().device_params()) == 15


def test_main_path_counts_no_launch_on_cpu():
    solver = tm.MHDSolver((8, 8, 16), strategy="swc", fuse_rk_axpy=True,
                          device=CPU)
    before = emit.fused_stencil_swc.launches
    solver.step(solver.init_fields(0), 1e-3)
    assert emit.fused_stencil_swc.launches == before


def test_integrate_matches_repeated_calls():
    p = td.DiffusionProblem((20,))
    op = p.step_op("swc", device=CPU)
    f = p.init_field(1, device=CPU, dtype="float64")
    want = f
    for _ in range(3):
        want = op(want)
    assert torch.equal(integrate(op, f, 3), want)


# --- convert: the reference's state handed across ------------------------------


def test_convert_operator_set_params_and_fields():
    jops = js.derivative_operator_set(3, 6, (0.1, 0.2, 0.3))
    tops = convert.operator_set_from_arrays(
        jops.names,
        [np.asarray(s.offsets) for s in jops.ops],
        [np.asarray(s.coeffs) for s in jops.ops],
    )
    t_off, t_c, t_st = emit.tap_table(tops)
    ref_ops = derivative_operator_set(3, 6, (0.1, 0.2, 0.3))
    r_off, r_c, r_st = emit.tap_table(ref_ops)
    assert torch.equal(t_off, r_off) and torch.equal(t_st, r_st)
    assert float((t_c - r_c).abs().max()) <= 1e-14

    jp = jm.MHDParams(nu=1e-2, kappa=3e-3)
    tp = convert.mhd_params_from_dict(dataclasses.asdict(jp))
    assert tp == tm.MHDParams(nu=1e-2, kappa=3e-3)
    assert tp.lnT0 == jp.lnT0
    with pytest.raises(TypeError):
        convert.mhd_params_from_dict({"viscosity": 1.0})

    f = jm.MHDSolver((4, 4, 4)).init_smooth(0)
    t = convert.fields_from_numpy(f, device=CPU, dtype="float32")
    assert t.dtype == torch.float32 and t.shape == (8, 4, 4, 4)
    assert np.array_equal(t.numpy(), np.asarray(f, np.float32))


def test_converted_state_drives_the_same_rhs():
    """JAX's operator set, parameters and fields → the port's RHS."""
    n = 12
    jsol = jm.MHDSolver((n, n, n), params=jm.MHDParams(nu=2e-3))
    f = jsol.init_smooth(3, amplitude=1e-2)
    want = jsol.rhs(f)
    tops = convert.operator_set_from_arrays(
        jsol.operator_set.names,
        [s.offsets for s in jsol.operator_set.ops],
        [s.coeffs for s in jsol.operator_set.ops],
    )
    params = convert.mhd_params_from_dict(dataclasses.asdict(jsol.params))
    ft = convert.fields_from_numpy(f, device=CPU)
    op = FusedStencilOp(tops, tm.mhd_rhs_device_phi(params), 8,
                        strategy="swc", block=(1, 4, 12), device=CPU)
    assert _rel(op(ft).numpy(), want) <= TOL["float64"]
