"""The port's MMS convergence harness (``repro_torch.verify.mms``)
against the JAX package's, and ``tests/test_convergence.py``'s slope
gates on the port.

- ``manufactured_solution``: the same numpy fields, cast once: equal.
- ``run_convergence``'s per-grid errors: within 1e-9 relative of the
  reference's on periodic grids (both sum the same taps in the same
  order). On dirichlet grids the wall cells' dense contractions sum in
  another order than XLA's, and their terms reach ~1e4 times the result
  (order 8 at h = 1/11, order 2 at h = 1/95), so roundoff moves a grid's
  error by up to ~1e-8 of itself: there the errors agree within the
  distance of the two outputs, |e_port − e_ref| ≤ 1e-9 e_ref +
  ‖out_port − out_ref‖ / ‖∇²f‖ (RMS norms; the triangle inequality),
  and the outputs differ by summation order only: at most 4 eps times
  the largest sum of |weight × value| a point adds.
- Slope bounds (the reference's): nominal − 0.25 ≤ slope ≤ nominal +
  1.2 (Dirichlet's offset rows superconverge pre-asymptotically).
"""
import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.verify import mms as jmms  # noqa: E402
from repro_torch.core import boundary as tb  # noqa: E402
from repro_torch.verify import mms as tmms  # noqa: E402
from repro_torch.verify import (  # noqa: E402
    MMSResult,
    fit_slope,
    manufactured_solution,
    run_convergence,
)

SLOPE_DEFICIT = 0.25
SLOPE_EXCESS = 1.2


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.asarray(x, np.float64) ** 2)))


def _roundoff_scale(f, accuracy, h, boundary) -> float:
    """max over points of Σ |w f| that the Laplacian's rows sum."""
    f = np.abs(np.asarray(f, np.float64)[0])
    total = np.zeros_like(f)
    mode = "periodic" if boundary == "periodic" else "dirichlet"
    for a, n in enumerate(f.shape):
        D = np.abs(tb.derivative_matrix_1d(n, 2, accuracy, h, mode))
        total += np.moveaxis(np.tensordot(f, D, axes=([a], [1])), -1, a)
    return float(total.max())


def test_constants_are_the_reference_ones():
    assert tmms._PHASES == jmms._PHASES and tmms._FREQS == jmms._FREQS
    assert tmms.DEFAULT_NS == jmms.DEFAULT_NS
    assert tmms.DEFAULT_NS_ORDER8 == jmms.DEFAULT_NS_ORDER8
    assert [f.name for f in MMSResult.__dataclass_fields__.values()] == [
        f.name for f in jmms.MMSResult.__dataclass_fields__.values()]


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize(
    "boundary", ("periodic", "dirichlet", "neumann", "neumann2"))
@pytest.mark.parametrize("rank", (1, 2, 3))
def test_manufactured_solution_equals_reference(rank, boundary, dtype):
    f, lap, h = manufactured_solution(rank, boundary, 12, dtype, "cpu")
    jf, jlap, jh = jmms.manufactured_solution(rank, boundary, 12, dtype)
    assert h == jh and f.shape == (1,) + (12,) * rank
    assert f.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(lap.numpy(), np.asarray(jlap))


def test_manufactured_solution_rejects_unknown_boundary():
    with pytest.raises(ValueError, match="reflect"):
        manufactured_solution(1, "reflect", 12, device="cpu")


def test_fit_slope_cases():
    assert fit_slope([0.1, 0.05], [1e-2, 0.0]) == float("inf")
    assert fit_slope([0.1], [1e-2]) == float("inf")
    s = fit_slope([0.1, 0.05, 0.025], [1e-2, 2.5e-3, 6.25e-4])
    assert abs(s - 2.0) < 1e-9
    hs, errs = [0.2, 0.1, 0.05, 0.025], [3e-2, 2e-3, 1.3e-4, 8e-6]
    assert fit_slope(hs, errs) == jmms.fit_slope(hs, errs)


@pytest.mark.parametrize("boundary", ("periodic", "dirichlet"))
@pytest.mark.parametrize("rank", (1, 2, 3))
@pytest.mark.parametrize("accuracy", (2, 8))
def test_run_convergence_errors_match_reference(accuracy, rank, boundary):
    got = run_convergence(rank, accuracy, boundary, device="cpu")
    want = jmms.run_convergence(rank, accuracy, boundary)
    assert (got.ns, got.hs, got.boundary_weights) == (
        want.ns, want.hs, want.boundary_weights)
    for n, e_got, e_want in zip(got.ns, got.errors, want.errors):
        f, lap, h = manufactured_solution(rank, boundary, n, device="cpu")
        jf, jlap, _ = jmms.manufactured_solution(rank, boundary, n)
        kw = dict(boundary_weights=boundary == "dirichlet")
        out = tmms.laplacian_op(rank, accuracy, h, boundary, device="cpu",
                                **kw)(f).numpy()
        jout = np.asarray(jmms.FusedStencilOp(
            jmms.OperatorSet((jmms.laplacian_stencil(rank, accuracy,
                                                     spacing=h),)),
            lambda d: d["lap"], 1, boundary_mode=boundary, **kw)(jf))
        eps = np.finfo(np.float64).eps
        assert np.abs(out - jout).max() <= 4 * eps * _roundoff_scale(
            f, accuracy, h, boundary), n
        gap = _rms(out - jout) / _rms(lap.numpy())
        assert abs(e_got - e_want) <= 1e-9 * e_want + gap, n
        if boundary == "periodic":
            assert abs(e_got - e_want) <= 1e-9 * e_want, n
    if boundary == "periodic":
        assert abs(got.slope - want.slope) <= 1e-9 * abs(want.slope)


@pytest.mark.parametrize("boundary", ["periodic", "dirichlet"])
@pytest.mark.parametrize("rank", [1, 2, 3])
@pytest.mark.parametrize("accuracy", [2, 4, 8])
def test_mms_slope_f64(accuracy, rank, boundary):
    res = run_convergence(rank, accuracy, boundary, device="cpu")
    assert res.slope >= accuracy - SLOPE_DEFICIT, res
    assert res.slope <= accuracy + SLOPE_EXCESS, res


@pytest.mark.parametrize("boundary", ["periodic", "dirichlet"])
@pytest.mark.parametrize("rank", [1, 2])
def test_mms_slope_f32_order2(rank, boundary):
    ns = (8, 12, 16, 24) if boundary == "dirichlet" else None
    res = run_convergence(rank, 2, boundary, dtype="float32", ns=ns,
                          device="cpu")
    assert res.slope >= 2 - SLOPE_DEFICIT, res
    assert res.slope <= 2 + SLOPE_EXCESS, res


@pytest.mark.parametrize("boundary", ["periodic", "dirichlet"])
@pytest.mark.parametrize("rank", [1, 2])
def test_mms_slope_f32_order4(rank, boundary):
    res = run_convergence(rank, 4, boundary, dtype="float32", ns=(8, 12, 16),
                          device="cpu")
    assert res.slope >= 4 - SLOPE_DEFICIT, res
    assert res.slope <= 4 + SLOPE_EXCESS, res


@pytest.mark.parametrize("boundary", ["periodic", "dirichlet"])
def test_mms_f32_order8_error_floor(boundary):
    res = run_convergence(1, 8, boundary, dtype="float32", device="cpu")
    assert max(res.errors) <= 2e-3, res


def test_mms_neumann_ghost_fill_order_gap():
    lo = run_convergence(1, 6, "neumann", device="cpu")
    hi = run_convergence(1, 6, "neumann2", device="cpu")
    assert lo.slope < 1.2, lo
    assert hi.slope > 4.0, hi
    assert hi.slope - lo.slope > 2.0


@pytest.mark.parametrize(
    "strategy,dtype,rank,boundary",
    [("swc", "float64", 2, "periodic"), ("swc", "float64", 3, "dirichlet"),
     ("swc_stream", "float64", 2, "dirichlet"),
     ("tc", "float32", 2, "dirichlet")],
)
def test_mms_slope_strategy_invariant(strategy, dtype, rank, boundary):
    """The slope is a property of the weights, not the lowering: each
    CUDA strategy's path (its plain version here) reproduces hwc's."""
    ns = (8, 12, 16) if dtype == "float32" else None
    res = run_convergence(rank, 4, boundary, dtype=dtype, strategy=strategy,
                          ns=ns, device="cpu")
    base = run_convergence(rank, 4, boundary, dtype=dtype, ns=ns,
                           device="cpu")
    assert res.slope >= 4 - SLOPE_DEFICIT, res
    assert res.slope <= 4 + SLOPE_EXCESS, res
    assert abs(res.slope - base.slope) <= 0.01


def test_run_convergence_refuses_what_the_kernels_refuse():
    with pytest.raises(ValueError, match="swc"):
        run_convergence(1, 2, strategy="swc_stream", device="cpu")
    with pytest.raises((ValueError, NotImplementedError)):
        run_convergence(2, 2, strategy="tc", dtype="float64", device="cpu")
