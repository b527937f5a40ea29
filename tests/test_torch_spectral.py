"""The port's spectral oracle (``repro_torch.physics.spectral``, on
``torch.fft``) against the JAX package's (numpy FFTs), and the MHD RHS
of the port against it at 6th order (``tests/test_physics.py``'s
oracle test, on the port's strategies). Both oracles run in float64:
1e-12 of the largest |value|.
"""
import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.physics import mhd as jmhd  # noqa: E402
from repro.physics import spectral as jsp  # noqa: E402
from repro_torch.physics import mhd as tmhd  # noqa: E402
from repro_torch.physics import spectral as tsp  # noqa: E402


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _fields(shape, seed=0, amp=1e-2):
    return np.random.default_rng(seed).standard_normal(
        (tmhd.N_FIELDS,) + shape) * amp


@pytest.mark.parametrize("shape", ((8, 8, 8), (8, 12, 16), (16, 16, 16)))
def test_wavenumbers_match_reference(shape):
    h = tuple(2 * np.pi / n for n in shape)
    for got, want in zip(tsp._wavenumbers(shape, h), jsp._wavenumbers(shape, h)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("shape", ((8, 8, 8), (8, 12, 16), (16, 16, 16)))
def test_spectral_derivatives_match_reference(shape):
    f = _fields(shape, seed=sum(shape))
    h = tuple(2 * np.pi / n for n in shape)
    want = jsp.spectral_derivatives(f, h)
    got = tsp.spectral_derivatives(torch.from_numpy(f).float(), h)
    assert set(got) == set(want)
    f32 = f.astype(np.float32).astype(np.float64)  # the port took f32
    want = jsp.spectral_derivatives(f32, h)
    for name in want:
        assert got[name].dtype == torch.float64
        assert _rel(got[name], want[name]) <= 1e-12, name


@pytest.mark.parametrize("shape", ((8, 8, 8), (16, 16, 16)))
def test_spectral_rhs_matches_reference(shape):
    f = _fields(shape, seed=3)
    solver = tmhd.MHDSolver(shape, device="cpu")
    want = jsp.spectral_rhs(f, solver.spacing,
                            jmhd.mhd_rhs_phi(jmhd.MHDParams()))
    got = tsp.spectral_rhs(torch.from_numpy(f), solver.spacing,
                           tmhd.mhd_rhs_phi(solver.params))
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got, want) <= 1e-12
    # A DevicePhi's own torch_fn is the same map.
    dev = tsp.spectral_rhs(torch.from_numpy(f), solver.spacing,
                           tmhd.mhd_rhs_device_phi(solver.params).torch_fn)
    assert torch.equal(dev, got)


@pytest.mark.parametrize("strategy", ("hwc", "swc"))
def test_mhd_rhs_matches_spectral_oracle_6th_order(strategy):
    """``tests/test_physics.py``'s gate on the port: the FD RHS within
    5e-4 of the spectral one at 32³, converging at more than 5th order
    from 16³."""
    errs = {}
    for n in (16, 32):
        solver = tmhd.MHDSolver((n,) * 3, strategy=strategy, device="cpu")
        f = solver.init_smooth(seed=0, amplitude=1e-2)
        rhs_fd = solver.rhs(f)
        rhs_sp = tsp.spectral_rhs(f, solver.spacing,
                                  tmhd.mhd_rhs_phi(solver.params))
        errs[n] = float((rhs_fd - rhs_sp).abs().max() / rhs_sp.abs().max())
    order = np.log2(errs[16] / errs[32])
    assert errs[32] < 5e-4
    assert order > 5.0, f"expected ~6th order, got {order:.2f}"


def test_smooth_init_is_the_reference_tests_field():
    """``MHDSolver.init_smooth(amplitude=1e-2)`` draws
    ``tests/test_physics.py``'s ``_smooth_fields``."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "ref_physics_tests", Path(__file__).with_name("test_physics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = mod._smooth_fields(16, seed=1)
    got = tmhd.MHDSolver((16,) * 3, device="cpu").init_smooth(
        seed=1, amplitude=1e-2)
    np.testing.assert_array_equal(got.numpy(), want)
