"""The port's boundary-modified weight rows (``repro_torch.core.boundary``:
``derivative_matrix_1d``, ``apply_operator_set_bc``) and
``FusedStencilOp(boundary_weights=True)`` against the JAX package's.

Tolerances, max |err| over the largest |value|: the matrices are built
by the same numpy code and must be equal; the contractions sum in
different orders (``torch.tensordot`` against ``jnp.tensordot``), so
1e-12 f64, 1e-5 f32, and 2e-2 bf16 (the port contracts bf16 with f32
accumulation, XLA on the CPU may not). Outside the wall shell the
blended output equals the unblended one bit for bit.
"""
import functools

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import boundary as jb  # noqa: E402
from repro.core import stencil as js  # noqa: E402
from repro.core.fusion import FusedStencilOp as JaxOp  # noqa: E402
from repro.physics.mhd import MHDSolver as JaxMHD  # noqa: E402
from repro_torch.core import boundary as tb  # noqa: E402
from repro_torch.core import stencil as ts  # noqa: E402
from repro_torch.core.fusion import FusedStencilOp  # noqa: E402
from repro_torch.kernels.phi import select_phi  # noqa: E402
from repro_torch.physics import mhd as tmhd  # noqa: E402

TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 2e-2}
MODES = ("periodic", "dirichlet", "neumann", "neumann2", "reflect")
SHAPES = {1: (24,), 2: (12, 20), 3: (8, 10, 12)}
MIXED = {
    1: ("neumann2",),
    2: ("dirichlet", "periodic"),
    3: ("reflect", "dirichlet", "periodic"),
}
# The dtypes each strategy's kernel takes.
STRATEGY_DTYPES = [
    ("hwc", "float64"), ("hwc", "float32"), ("hwc", "bfloat16"),
    ("swc", "float64"), ("swc", "float32"), ("swc", "bfloat16"),
    ("swc_stream", "float64"), ("swc_stream", "float32"),
    ("tc", "float32"), ("tc", "bfloat16"),
]


def _rel(a, b) -> float:
    a = np.asarray(torch.as_tensor(a).double() if isinstance(a, torch.Tensor)
                   else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _field(shape, dtype, seed=0):
    """Standard normal draws rounded to float32, then cast to ``dtype``
    in torch and handed to the reference as they are (bf16 equal in
    both)."""
    f = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    tt = torch.from_numpy(f).to(getattr(torch, dtype))
    return tt, jnp.asarray(tt.float().numpy()).astype(dtype)


def _shell(spatial, radii, modes):
    """True within r of a non-periodic face (the reference's mask)."""
    mask = np.zeros(spatial, bool)
    for a, (n, r, m) in enumerate(zip(spatial, radii, modes)):
        if m == "periodic" or r == 0:
            continue
        idx = np.arange(n)
        shape = [1] * len(spatial)
        shape[a] = n
        mask |= ((idx < r) | (idx >= n - r)).reshape(shape)
    return mask


@pytest.mark.parametrize("deriv", (0, 1, 2))
@pytest.mark.parametrize("mode", MODES)
def test_derivative_matrix_equals_reference(mode, deriv):
    for n in (10, 13, 24):
        for accuracy in (2, 4, 6, 8):
            if mode != "periodic" and n < deriv + accuracy:
                continue
            want = jb.derivative_matrix_1d(n, deriv, accuracy, 0.37, mode)
            got = tb.derivative_matrix_1d(n, deriv, accuracy, 0.37, mode)
            np.testing.assert_array_equal(got, want)


def test_derivative_matrix_rejects_what_the_reference_rejects():
    for args in ((6, 2, 8, 1.0, "dirichlet"), (6, 2, 8, 1.0, "periodic"),
                 (12, 1, 2, 1.0, "wrap")):
        with pytest.raises(ValueError):
            jb.derivative_matrix_1d(*args)
        with pytest.raises(ValueError):
            tb.derivative_matrix_1d(*args)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("mixed", (False, True))
@pytest.mark.parametrize("accuracy", (2, 6))
@pytest.mark.parametrize("rank", (1, 2, 3))
def test_apply_operator_set_bc_matches_reference(rank, accuracy, mixed, dtype):
    modes = MIXED[rank] if mixed else "dirichlet"
    tf, jf = _field((2,) + SHAPES[rank], dtype, seed=rank)
    got = tb.apply_operator_set_bc(
        tf, ts.derivative_operator_set(rank, accuracy, 0.3), modes,
        spatial_axes=range(1, rank + 1),
    )
    want = jb.apply_operator_set_bc(
        jf, js.derivative_operator_set(rank, accuracy, 0.3), modes,
        spatial_axes=range(1, rank + 1),
    )
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == getattr(torch, dtype)
        assert _rel(got[name], want[name]) <= TOL[dtype], name
    # Some rows alone (both walls, the interior): equal to those rows of
    # the whole evaluation (up to summation order).
    ops = ts.derivative_operator_set(rank, accuracy, 0.3)
    for a in range(rank):
        n = SHAPES[rank][a]
        for picked in ((0, 1, 2, n - 3, n - 2, n - 1), (0,), (4, 5, 6)):
            slab = tb.apply_operator_set_bc(
                tf, ops, modes, spatial_axes=range(1, rank + 1),
                rows=(a, picked),
            )
            for name, whole in got.items():
                want_rows = whole.index_select(1 + a, torch.tensor(picked))
                assert _rel(slab[name], want_rows) <= TOL[dtype], (
                    a, picked, name)


@functools.lru_cache(maxsize=None)
def _reference_blend(rank, dtype, modes, lead):
    """The reference's hwc op with the blend (shared by the strategies)."""
    _, jf = _field(lead + SHAPES[rank], dtype, seed=len(lead))
    name = "dxx" if rank == 1 else "dxy"
    return JaxOp(
        js.derivative_operator_set(rank, 6, 0.3), lambda d: d[name],
        2, boundary_mode=modes, boundary_weights=True,
    )(jf)


@pytest.mark.parametrize(
    "rank,strategy,dtype",
    [(rank, s, d) for rank in (1, 2, 3) for s, d in STRATEGY_DTYPES
     if not (s == "swc_stream" and rank == 1)],  # rank 1 raises there
)
def test_fused_op_blend_matches_reference(rank, strategy, dtype):
    """Each strategy with the blend against the reference's hwc with its
    blend, unbatched and at B = 3, scalar and mixed modes; outside the
    shell the output is the unblended op's, bit for bit."""
    spatial = SHAPES[rank]
    for modes in ("dirichlet", MIXED[rank]):
        for lead in ((2,), (3, 2)):
            tf, _ = _field(lead + spatial, dtype, seed=len(lead))
            name = "dxx" if rank == 1 else "dxy"
            want = _reference_blend(rank, dtype, modes, lead)
            ops = ts.derivative_operator_set(rank, 6, 0.3)
            kw = dict(boundary_mode=modes, strategy=strategy, device="cpu")
            got = FusedStencilOp(
                ops, select_phi(name), 2, boundary_weights=True, **kw
            )(tf)
            plain = FusedStencilOp(ops, select_phi(name), 2, **kw)(tf)
            assert got.shape == plain.shape == tuple(want.shape)
            assert got.dtype == getattr(torch, dtype)
            assert _rel(got, want) <= TOL[dtype], (modes, lead)
            inside = ~_shell(spatial, ops.radius_per_axis(),
                             tb._normalize_modes(modes, rank))
            assert torch.equal(got[..., torch.from_numpy(inside)],
                               plain[..., torch.from_numpy(inside)])
            assert not torch.equal(got, plain)


@pytest.mark.parametrize("batched", (False, True))
def test_blend_with_aux_phi_matches_reference(batched):
    """φ with aux: a bare callable on hwc, and the MHD fused-axpy substep
    (a DevicePhi's ``torch_fn``) on swc, each against the reference's hwc
    blend with the same φ."""
    rng = np.random.default_rng(7)
    lead = (2,) if batched else ()
    f = rng.standard_normal(lead + (2, 12, 20)) * 0.1
    aux = rng.standard_normal(lead + (2, 12, 20))
    modes = ("dirichlet", "neumann")

    def phi(d, a):
        return d["dxx"] + 0.5 * a * d["dy"]

    want = JaxOp(
        js.derivative_operator_set(2, 4, 0.3), phi, 2, boundary_mode=modes,
        boundary_weights=True,
    )(jnp.asarray(f), jnp.asarray(aux))
    got = FusedStencilOp(
        ts.derivative_operator_set(2, 4, 0.3), phi, 2, boundary_mode=modes,
        boundary_weights=True, device="cpu",
    )(torch.from_numpy(f), torch.from_numpy(aux))
    assert _rel(got, want) <= TOL["float64"]

    n = (8, 10, 12)
    f = rng.uniform(-1e-2, 1e-2, lead + (8,) + n)
    w = rng.uniform(-1e-3, 1e-3, lead + (8,) + n)
    jsolver = JaxMHD(n, strategy="hwc")
    want = JaxOp(
        jsolver.operator_set, jsolver._substep_phi(0.5, 0.25, 1e-3), 16,
        boundary_mode="dirichlet", boundary_weights=True,
    )(jnp.asarray(f), jnp.asarray(w))
    tsolver = tmhd.MHDSolver(n, device="cpu")
    op = FusedStencilOp(
        tsolver.operator_set,
        tmhd.mhd_substep_device_phi(tsolver.params, 0.5, 0.25, 1e-3), 16,
        boundary_mode="dirichlet", strategy="swc", boundary_weights=True,
        device="cpu",
    )
    assert _rel(op(torch.from_numpy(f), torch.from_numpy(w)), want) \
        <= TOL["float64"]


def test_boundary_weights_rules():
    raw = ts.OperatorSet((ts.StencilSpec(((-1,), (0,), (1,)),
                                         (1.0, -2.0, 1.0), name="lap"),))
    with pytest.raises(ValueError, match="OperatorSpec"):
        FusedStencilOp(raw, select_phi("lap"), 1, boundary_mode="dirichlet",
                       boundary_weights=True, device="cpu")
    ops = ts.derivative_operator_set(2, 4, 0.5)
    # Temporal fusion still needs periodic modes on every axis...
    with pytest.raises(ValueError, match="periodic"):
        FusedStencilOp(ops, select_phi("dxx"), 1, boundary_mode="dirichlet",
                       boundary_weights=True, fuse_steps=2, device="cpu")
    # ...with them the option is accepted and nothing is blended.
    f = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 8, 16)))
    op = FusedStencilOp(ops, select_phi("dxx"), 1, strategy="swc",
                        boundary_weights=True, device="cpu")
    plain = FusedStencilOp(ops, select_phi("dxx"), 1, strategy="swc",
                           device="cpu")
    assert torch.equal(op(f), plain(f))
    deeper = op.with_depth(2)
    assert deeper.boundary_weights and deeper.fuse_steps == 2
    walled = FusedStencilOp(ops, select_phi("dxx"), 1, strategy="swc",
                            boundary_mode="dirichlet", boundary_weights=True,
                            device="cpu")
    assert walled.with_depth(1).boundary_weights
    with pytest.raises(ValueError, match="periodic"):
        walled.with_depth(2)
