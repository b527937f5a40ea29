"""The 1-D cross-correlation in the port (``ops.xcorr1d``, B6
``csrc/xcorr1d.cu``) and the 1-D diffusion step on it
(``step_1d_xcorr``), against the JAX package.

The JAX side runs as ``tests/test_kernels.py`` and
``tests/test_physics.py`` run it: ``xcorr1d_pallas`` in interpret mode
and ``repro.kernels.ref``. Inputs are numpy draws from a seed handed to
both packages. On the CPU the port's wrapper takes its plain version
(``ref.xcorr1d``), so these tests hold the port's dispatch, rules and
plain arithmetic to the reference; tests marked ``cuda`` hold the CUDA
kernel to that plain version and skip without a card.

Tolerances, relative to the largest |reference|: 1e-6 in float32 and
1e-12 in float64, tighter than the reference's own 1e-4 and 1e-10
(``tests/test_kernels.py:48``). Both packages sum the same taps in the
same order; XLA may contract a multiply-add into one FMA where PyTorch
rounds twice, a few float32 roundings at most (2.4e-7 was the largest
seen). On the card the kernel sums with FMAs: 1e-5 and 1e-12 there, as
for the other kernels.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import stencil as js  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.stencil1d import xcorr1d_pallas  # noqa: E402  # repolint: allow[legacy-kernel-import]
from repro.physics import diffusion as jd  # noqa: E402
from repro_torch.core import stencil as ts  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref, xcorr1d  # noqa: E402
from repro_torch.physics import diffusion as td  # noqa: E402

TOL = {"float32": 1e-6, "float64": 1e-12}
CARD_TOL = {"float32": 1e-5, "float64": 1e-12}
CPU = "cpu"
STRATEGY_UNROLL = [("baseline", 1), ("pointwise", 4), ("pointwise", 7),
                   ("elementwise", 4)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _inputs(n, radius, dtype, seed=42):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n + 2 * radius).astype(dtype)
    g = rng.standard_normal(2 * radius + 1).astype(dtype)
    return f, g


# --- the port against JAX ------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("radius", (0, 1, 5, 32, 200))
@pytest.mark.parametrize("strategy,unroll", STRATEGY_UNROLL)
def test_xcorr1d_matches_jax(dtype, radius, strategy, unroll):
    """The reference's grid (``tests/test_kernels.py:36-41``)."""
    f, g = _inputs(2048, radius, dtype, seed=radius)
    want = xcorr1d_pallas(jnp.asarray(f), jnp.asarray(g), strategy=strategy,
                          block_size=512, unroll=unroll, interpret=True)
    got = tops.xcorr1d(torch.from_numpy(f), torch.from_numpy(g),
                       strategy=strategy, block_size=512, unroll=unroll)
    assert got.shape == (2048,) and got.dtype == getattr(torch, dtype)
    assert _rel(got.numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("strategy", ("hwc", "baseline", "elementwise"))
def test_xcorr1d_nondivisible_n(strategy):
    """n = 1000 with 256-output blocks (``tests/test_kernels.py:56``)."""
    f, g = _inputs(1000, 3, "float32", seed=7)
    want = jops.xcorr1d(jnp.asarray(f), jnp.asarray(g), strategy=strategy,
                        block_size=256, interpret=True)
    got = tops.xcorr1d(torch.from_numpy(f), torch.from_numpy(g),
                       strategy=strategy, block_size=256)
    assert got.shape == (1000,)
    assert _rel(got.numpy(), want) <= TOL["float32"]


def test_plain_versions_match_the_reference_oracles():
    f, g = _inputs(300, 4, "float64", seed=3)
    want = jref.xcorr1d_numpy(f, g)
    np.testing.assert_array_equal(ref.xcorr1d_numpy(f, g), want)
    got = ref.xcorr1d(torch.from_numpy(f), torch.from_numpy(g))
    assert _rel(got.numpy(), want) <= TOL["float64"]
    # g is cast to the field dtype before the multiply, as the reference
    f32 = ref.xcorr1d(torch.from_numpy(f.astype(np.float32)),
                      torch.from_numpy(g))
    assert f32.dtype == torch.float32
    jf32 = jref.xcorr1d(jnp.asarray(f, jnp.float32), jnp.asarray(g))
    assert _rel(f32.numpy(), jf32) <= TOL["float32"]


def test_stencil_copies_match_the_reference():
    g = js.diffusion_kernel_1d(6, 1e-3, 1.0, 0.1)
    np.testing.assert_array_equal(ts.diffusion_kernel_1d(6, 1e-3, 1.0, 0.1), g)
    for ndim in (1, 2, 3):
        a = ts.xcorr_operator_set(g, ndim).ops[0]
        b = js.xcorr_operator_set(g, ndim).ops[0]
        assert (a.offsets, a.coeffs, a.name) == (b.offsets, b.coeffs, b.name)


# --- the 1-D diffusion step ----------------------------------------------------


@pytest.mark.parametrize("strategy", ("hwc", "baseline", "pointwise",
                                      "elementwise"))
def test_step_1d_xcorr_matches_jax(strategy):
    p_j = jd.DiffusionProblem((3000,), accuracy=6)
    f0 = np.array(p_j.init_field(seed=2))[0]  # float32 (n,)
    want = f0
    got = torch.from_numpy(f0)
    p_t = td.DiffusionProblem((3000,), accuracy=6)
    for _ in range(3):
        want = jd.step_1d_xcorr(jnp.asarray(want), p_j, strategy=strategy,
                                block_size=512)
        got = td.step_1d_xcorr(got, p_t, strategy=strategy, block_size=512)
    assert got.shape == (3000,) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL["float32"]


@pytest.mark.parametrize("strategy", ("hwc", "baseline"))
def test_step_1d_xcorr_equals_the_fused_step(strategy):
    """As ``tests/test_physics.py:52`` holds the reference: one xcorr
    step equals one ``hwc`` step of the merged stencil, in float64."""
    p = td.DiffusionProblem((64,), accuracy=6)
    f = p.fourier_mode((3,), device=CPU)
    a = td.step_1d_xcorr(f[0], p, strategy=strategy)
    b = p.step_op("hwc", device=CPU)(f)[0]
    assert float((a - b).abs().max()) < 1e-14
    c = td.simulate(p, f, 1, strategy="hwc", device=CPU)[0]
    assert float((a - c).abs().max()) < 1e-14


# --- the rules -----------------------------------------------------------------


def test_xcorr1d_rules_follow_the_reference():
    f, g = (torch.from_numpy(a) for a in _inputs(64, 2, "float32"))
    jf, jg = jnp.asarray(f.numpy()), jnp.asarray(g.numpy())
    with pytest.raises(ValueError, match="strategy"):
        tops.xcorr1d(f, g, strategy="diagonal")
    with pytest.raises(ValueError, match="strategy"):
        jops.xcorr1d(jf, jg, strategy="diagonal", interpret=True)
    with pytest.raises(ValueError, match="divide by unroll"):
        tops.xcorr1d(f, g, strategy="elementwise", block_size=30, unroll=4)
    with pytest.raises(ValueError, match="divide by unroll"):
        jops.xcorr1d(jf, jg, strategy="elementwise", block_size=30, unroll=4,
                     interpret=True)
    with pytest.raises(NotImplementedError, match="A9"):
        tops.xcorr1d(f, g, block_size="auto")
    with pytest.raises(ValueError, match="1-D"):
        tops.xcorr1d(f[None], g)
    with pytest.raises(ValueError, match="no output"):
        tops.xcorr1d(f[:4], g)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    f, g = (torch.from_numpy(a) for a in _inputs(100, 2, "float64"))
    xcorr1d.reset_launch_counts()
    for strategy in xcorr1d.STRATEGIES:
        got = tops.xcorr1d(f, g, strategy=strategy, block_size=32)
        assert torch.equal(got, ref.xcorr1d(f, g))
    assert xcorr1d.xcorr1d_cuda.launches == 0
    assert not xcorr1d.xcorr1d_cuda.launches_by_strategy
    # bf16 runs the plain version on the CPU; the card's kernel takes it
    # not yet (ROADMAP B6b)
    assert tops.xcorr1d(f.bfloat16(), g).dtype == torch.bfloat16


def test_launch_layout_by_hand():
    """Threads and shared bytes of one block, counted by hand from
    ``csrc/xcorr1d.cu``: min(block_size / U_e, 1024) threads (U_e the
    unroll on elementwise, else 1); the window of block_size + 2r inputs
    padded to 16 B, then 2r + 1 taps."""
    L = xcorr1d.launch_threads
    assert L(2048, "baseline", 4) == 1024  # two passes
    assert L(512, "baseline", 1) == 512
    assert L(512, "pointwise", 7) == 512  # unroll is along the taps
    assert L(2048, "elementwise", 4) == 512
    assert L(4096, "elementwise", 2) == 1024  # 2048 lanes: two passes
    assert L(100, "elementwise", 5) == 20
    S = xcorr1d.smem_bytes
    assert S(3, 2048, "float32") == 8208 + 3 * 4  # 2050 x 4 B -> 8208
    assert S(3, 2044, "float32") == 8192 + 3 * 4  # 2046 x 4 B -> 8192
    assert S(2049, 4096, "float64") == 6144 * 8 + 2049 * 8 == 65_544
    assert S(1, 1, "float64") == 16 + 8
    # The largest window that fits 227 KB, and the first that does not.
    xcorr1d.check_launch(2049, 4096, "baseline", 1, "float64")
    # r = 1024 in f64: 26,006 window values (padded to 16 B) and 2,049
    # taps take 232,440 of the 232,448 bytes; one more output does not fit.
    assert S(2049, 24958, "float64") == 216_048 + 16_392 == 232_440
    xcorr1d.check_launch(2049, 24958, "baseline", 1, "float64")
    with pytest.raises(ValueError, match="shared memory"):
        xcorr1d.check_launch(2049, 24959, "baseline", 1, "float64")
    with pytest.raises(NotImplementedError, match="B6b"):
        xcorr1d.check_launch(3, 256, "baseline", 1, "bfloat16")
    with pytest.raises(NotImplementedError, match="B6b"):
        xcorr1d.check_launch(3, 256, "pointwise", 17, "float32")
    xcorr1d.check_launch(3, 256, "baseline", 17, "float32")  # runs U = 1


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("radius", (0, 1, 5, 32, 200, 1024))
@pytest.mark.parametrize("strategy,unroll", STRATEGY_UNROLL)
def test_xcorr1d_kernel_matches_plain_on_card(cuda_device, dtype, radius,
                                              strategy, unroll):
    n = (1 << 16) + 123  # a ragged last block
    f, g = (torch.from_numpy(a).to(cuda_device)
            for a in _inputs(n, radius, dtype, seed=radius))
    xcorr1d.reset_launch_counts()
    got = tops.xcorr1d(f, g, strategy=strategy, block_size=512,
                       unroll=unroll)
    assert xcorr1d.xcorr1d_cuda.launches_by_strategy == {strategy: 1}
    want = ref.xcorr1d(f, g)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= CARD_TOL[dtype]


@pytest.mark.cuda
def test_kernel_layout_is_the_python_formula(cuda_device):
    for n_taps, bs, strategy, u, dtype in (
        (3, 2048, "baseline", 4, "float32"),
        (2049, 4096, "elementwise", 4, "float64"),
        (401, 100, "elementwise", 5, "float32"),
        (65, 1000, "pointwise", 7, "float64"),
    ):
        assert xcorr1d.kernel_layout(n_taps, bs, strategy, u, dtype) == (
            xcorr1d.launch_threads(bs, strategy, u),
            xcorr1d.smem_bytes(n_taps, bs, dtype),
        )


@pytest.mark.cuda
def test_step_1d_xcorr_is_one_launch_on_card(cuda_device):
    p = td.DiffusionProblem((1 << 16,), accuracy=6)
    f = p.init_field(seed=0, device=cuda_device)[0]
    xcorr1d.reset_launch_counts()
    got = td.step_1d_xcorr(f, p, strategy="elementwise")
    assert xcorr1d.xcorr1d_cuda.launches == 1
    want = td.step_1d_xcorr(f, p, strategy="hwc")
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= CARD_TOL["float32"]
    with pytest.raises(NotImplementedError, match="B6b"):
        td.step_1d_xcorr(f.bfloat16(), p, strategy="baseline")
