"""The port's numpy stencil layer, plan and ghost padding against the
JAX package: Fornberg weights and operator sets to 1e-14, plan interior
and radii, and ``pad`` element for element in every boundary mode."""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import boundary as jb  # noqa: E402
from repro.core import stencil as js  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro_torch.core import boundary as tb  # noqa: E402
from repro_torch.core import stencil as ts  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402

ACCURACIES = (2, 4, 6, 8)


@pytest.mark.parametrize("accuracy", ACCURACIES)
@pytest.mark.parametrize("deriv", (1, 2, 3))
def test_central_and_offset_weights_match(deriv, accuracy):
    a = ts.central_difference_coeffs(deriv, accuracy)
    b = js.central_difference_coeffs(deriv, accuracy)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-14
    for left in range(0, deriv + accuracy):
        a = ts.offset_difference_coeffs(deriv, accuracy, left)
        b = js.offset_difference_coeffs(deriv, accuracy, left)
        assert np.abs(a - b).max() <= 1e-14 * max(1.0, np.abs(b).max())


def _same_operator_set(a, b, tol=1e-14):
    assert a.names == b.names
    assert a.radius_per_axis() == b.radius_per_axis()
    assert (a.n_k, a.taps_per_point, a.accuracy) == (
        b.n_k, b.taps_per_point, b.accuracy,
    )
    for sa, sb in zip(a.ops, b.ops):
        assert sa.offsets == sb.offsets  # same taps, same order
        ca, cb = np.asarray(sa.coeffs), np.asarray(sb.coeffs)
        assert np.abs(ca - cb).max() <= tol * max(1.0, np.abs(cb).max())


@pytest.mark.parametrize("accuracy", ACCURACIES)
@pytest.mark.parametrize("ndim", (1, 2, 3))
def test_derivative_operator_set_matches(ndim, accuracy):
    spacing = [0.3, 0.7, 1.1][:ndim]
    _same_operator_set(
        ts.derivative_operator_set(ndim, accuracy, spacing),
        js.derivative_operator_set(ndim, accuracy, spacing),
    )


def test_mhd_operator_set_is_the_papers():
    ops = ts.derivative_operator_set(3, 6)
    assert (ops.n_s, ops.taps_per_point, ops.n_k) == (10, 148, 127)
    assert ops.flops_per_point(8) == 2368


@pytest.mark.parametrize("ndim", (1, 2, 3))
def test_diffusion_kernel_matches(ndim):
    spacing = [0.2, 0.4, 0.1][:ndim]
    a = ts.diffusion_kernel_nd(ndim, 6, 1e-3, 0.7, spacing)
    b = js.diffusion_kernel_nd(ndim, 6, 1e-3, 0.7, spacing)
    _same_operator_set(ts.OperatorSet((a,)), js.OperatorSet((b,)))


@pytest.mark.parametrize(
    "shape,n_aux",
    [((2, 70), 0), ((1, 22, 46), 0), ((8, 14, 22, 38), 8), ((3, 10, 16, 20), 0)],
)
def test_plan_interior_and_radii_match(shape, n_aux):
    ndim = len(shape) - 1
    t = tplan.plan_stencil(
        ts.derivative_operator_set(ndim, 6), shape, shape[0], n_aux=n_aux
    )
    j = jplan.plan_stencil(
        js.derivative_operator_set(ndim, 6), shape, shape[0], n_aux=n_aux
    )
    assert (t.interior, t.radii, t.rank, t.n_f, t.n_aux, t.accuracy) == (
        j.interior, j.radii, j.rank, j.n_f, j.n_aux, j.accuracy,
    )
    for n, b in zip(t.interior, t.block):
        assert n % b == 0
    assert t.threads <= tplan.MAX_THREADS
    assert t.smem_bytes <= tplan.SMEM_PER_BLOCK


def test_plan_rejects_what_hopper_cannot_hold():
    ops = ts.derivative_operator_set(3, 6)
    shape = (8, 262, 262, 262)
    with pytest.raises(ValueError, match="shared memory"):
        tplan.plan_stencil(
            ops, shape, 8, block=(1, 16, 64), unroll=4, dtype="float64"
        )
    # Depth 1 on swc is persistent: a 2048-point tile runs on the kernel's
    # own threads, several outputs each (no longer one thread per point).
    big = tplan.plan_stencil(ops, shape, 8, block=(4, 16, 32))
    assert big.block == (4, 16, 32) and big.persistent
    assert (big.threads, big.outputs_per_thread) == tplan.swc_launch(
        1, "float32")
    assert big.threads * big.outputs_per_thread < 2048
    # tc (B4) is ported; float64 is not a tc type (the reference's rule).
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        tplan.plan_stencil(ops, shape, 8, strategy="tc", dtype="float64")
    # swc_stream (B3) is ported, for ranks 2 and 3 only.
    with pytest.raises(ValueError, match="strategy='swc'"):
        tplan.plan_stencil(ts.derivative_operator_set(1, 6), (1, 70), 1,
                           strategy="swc_stream")
    with pytest.raises(ValueError, match="dtype"):
        tplan.plan_stencil(ops, shape, 8, dtype="float16")
    # bf16 on swc at depth 1 is B1b (ported); the stream kernel waits.
    with pytest.raises(NotImplementedError, match="ROADMAP B3c"):
        tplan.plan_stencil(ops, shape, 8, dtype="bfloat16",
                           strategy="swc_stream")


def test_plan_unroll_and_clamp():
    ops = ts.derivative_operator_set(1, 6)
    p = tplan.plan_stencil(ops, (1, 1030), 1, block=(256,), unroll=2)
    assert (p.block, p.unroll, p.x_step) == ((256,), 2, 512)
    p = tplan.plan_stencil(ops, (1, 1000), 1, block=(256,), unroll=3)
    assert p.unroll == 1 and 994 % p.block[0] == 0


MODES = ("periodic", "dirichlet", "neumann", "neumann2", "reflect")


@pytest.mark.parametrize("mode", MODES + (("dirichlet", "periodic", "neumann2"),))
@pytest.mark.parametrize("radius", (1, 3, (2, 0, 4), 7))
def test_pad_matches_reference(mode, radius):
    rng = np.random.default_rng(0)
    f = rng.standard_normal((2, 5, 6, 4))
    kw = dict(spatial_axes=(1, 2, 3), value=0.25)
    a = tb.pad(torch.from_numpy(f), radius, mode, **kw).numpy()
    b = np.asarray(jb.pad(jnp.asarray(f), radius, mode, **kw))
    assert a.shape == b.shape
    assert np.array_equal(a, b)
    back = tb.unpad(torch.from_numpy(a), radius, spatial_axes=(1, 2, 3))
    assert np.array_equal(back.numpy(), f)


@pytest.mark.parametrize("ndim", (1, 2))
def test_pad_low_rank_default_axes(ndim):
    f = np.arange(7.0 * (3 if ndim == 2 else 1)).reshape((3, 7)[-ndim:])
    for mode in MODES:
        a = tb.pad(torch.from_numpy(f), 2, mode).numpy()
        b = np.asarray(jb.pad(jnp.asarray(f), 2, mode))
        assert np.array_equal(a, b), mode


def test_pad_rejects_bad_modes():
    f = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="unknown boundary mode"):
        tb.pad(f, 1, "mirror")
    with pytest.raises(ValueError, match="boundary modes"):
        tb.pad(f, 1, ("periodic",))
