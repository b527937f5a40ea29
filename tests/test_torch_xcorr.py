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

bfloat16 and float16 (B6b): both packages round each product and each
sum to the type. In bfloat16 the port equals the reference bit for bit;
in float16 XLA keeps more precision than one rounding per operation, so
the port is held within 2e-2 of the largest |reference| (the largest
distance seen here: 2.2e-3, at r = 32). On the card the kernel rounds
as the plain version does and equals it bit for bit in both.
"""
import collections
import math

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

TOL = {"float32": 1e-6, "float64": 1e-12, "bfloat16": 0.0,
       "float16": 2e-2}
CARD_TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 0.0,
            "float16": 0.0}
CPU = "cpu"
STRATEGY_UNROLL = [("baseline", 1), ("pointwise", 4), ("pointwise", 7),
                   ("elementwise", 4)]
# B6b: unroll factors past the kernel's register widths (1..16), which
# it runs in passes of their largest divisor of at most 16.
WIDE_UNROLLS = (24, 32, 64)
JDT = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}
TDT = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _inputs(n, radius, dtype, seed=42):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n + 2 * radius).astype(dtype)
    g = rng.standard_normal(2 * radius + 1).astype(dtype)
    return f, g


def _inputs_2byte(n, radius, dtype, seed=42):
    """(jax f, jax g, torch f, torch g) in bfloat16 or float16: standard
    normal draws rounded once, by JAX, then carried across exactly."""
    rng = np.random.default_rng(seed)
    fj = jnp.asarray(rng.standard_normal(n + 2 * radius), JDT[dtype])
    gj = jnp.asarray(rng.standard_normal(2 * radius + 1), JDT[dtype])

    def to_torch(a):
        return torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])

    return fj, gj, to_torch(fj), to_torch(gj)


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


@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
@pytest.mark.parametrize("radius", (0, 1, 5, 32))
@pytest.mark.parametrize("strategy,unroll", [("baseline", 1)] + [
    (s, u) for s in ("pointwise", "elementwise") for u in (4,) + WIDE_UNROLLS])
def test_xcorr1d_2byte_matches_jax(dtype, radius, strategy, unroll):
    """B6b: bfloat16 bit for bit, float16 within 2e-2 of the largest
    |reference|, on every strategy and at unroll factors past 16, the
    reference's kernel in interpret mode (block 768, which 24, 32 and 64
    divide; two tiles)."""
    fj, gj, ft, gt = _inputs_2byte(1536, radius, dtype, seed=radius + unroll)
    want = xcorr1d_pallas(fj, gj, strategy=strategy, block_size=768,
                          unroll=unroll, interpret=True)
    got = tops.xcorr1d(ft, gt, strategy=strategy, block_size=768,
                       unroll=unroll)
    assert got.shape == (1536,) and got.dtype == TDT[dtype]
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) \
        <= TOL[dtype]


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


@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
@pytest.mark.parametrize("strategy", ("hwc", "baseline", "pointwise",
                                      "elementwise"))
def test_step_1d_xcorr_2byte_matches_jax(dtype, strategy):
    """B6b's path: three ``step_1d_xcorr`` steps in bfloat16 and float16
    from the reference's field, against the reference's steps: bfloat16
    bit for bit, float16 within 2e-2 of the largest |reference| (equal
    bit for bit here too, but XLA may keep float16 sums wider)."""
    p_j = jd.DiffusionProblem((3000,), accuracy=6)
    f0 = np.array(p_j.init_field(seed=2))[0]
    want = jnp.asarray(f0, JDT[dtype])
    got = torch.from_numpy(np.array(want, np.float32)).to(TDT[dtype])
    p_t = td.DiffusionProblem((3000,), accuracy=6)
    for _ in range(3):
        want = jd.step_1d_xcorr(want, p_j, strategy=strategy, block_size=512)
        got = td.step_1d_xcorr(got, p_t, strategy=strategy, block_size=512)
    assert got.shape == (3000,) and got.dtype == TDT[dtype]
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) \
        <= TOL[dtype]


@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
@pytest.mark.parametrize("accuracy", (2, 4, 6, 8))
@pytest.mark.parametrize("dt,spacing", [(1e-3, 0.1), (1e-5, 1 / 300),
                                        (2.5e-4, 0.02)])
def test_xcorr_taps_round_as_the_reference(dtype, accuracy, dt, spacing):
    """The merged taps of Eq. 5 in a 2-byte type are the reference's
    ``jnp.asarray(diffusion_kernel_1d(...), dtype)`` bit for bit (float64
    rounded once)."""
    want = jnp.asarray(js.diffusion_kernel_1d(accuracy, dt, 1.0, spacing),
                       JDT[dtype])
    td._xcorr_taps.cache_clear()
    got = td._xcorr_taps(accuracy, dt, 1.0, spacing, TDT[dtype],
                         torch.device("cpu"))
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.array(want).view(np.int16))


def test_float64_taps_round_once_to_float16():
    """A float64 ``g`` on a float16 field is rounded once, as numpy and
    JAX round it: ``repro_torch.cast`` on a seeded draw where torch's own
    cast (through float32) differs, and ``ref.xcorr1d`` and the wrapper
    on those values (a unit impulse returns the taps reversed)."""
    from repro_torch import cast

    rng = np.random.default_rng(5)
    v = rng.standard_normal(200_000)
    once = v.astype(np.float16).view(np.uint16)
    twice = torch.from_numpy(v).to(torch.float16).numpy().view(np.uint16)
    differ = np.flatnonzero(twice != once)
    assert differ.size > 0
    np.testing.assert_array_equal(
        cast(torch.from_numpy(v), torch.float16).numpy().view(np.uint16),
        once)
    g = torch.from_numpy(v[differ])
    f = torch.zeros(2 * g.shape[0] - 1, dtype=torch.float16)
    f[g.shape[0] - 1] = 1
    for got in (ref.xcorr1d(f, g), tops.xcorr1d(f, g, strategy="pointwise")):
        np.testing.assert_array_equal(got.flip(0).numpy().view(np.uint16),
                                      once[differ])


def test_float64_to_float16_cast_refuses_a_gradient():
    """``repro_torch.cast`` takes no gradient on its float64 to float16
    route, so a float64 tensor that wants one is refused there; every
    other route is ``.to`` and keeps it."""
    from repro_torch import cast

    w = torch.ones(3, dtype=torch.float64, requires_grad=True)
    with pytest.raises(ValueError, match="gradient"):
        cast(w, torch.float16)
    assert cast(w, torch.float32).requires_grad


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


def test_xcorr1d_rules_follow_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path))
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
    # block_size="auto" (the tuner, ROADMAP A9) resolves and equals the
    # explicit launch.
    assert torch.equal(tops.xcorr1d(f, g, block_size="auto"),
                       tops.xcorr1d(f, g))
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
    # bf16 and f16 run the plain version on the CPU (and the kernel on
    # the card, B6b)
    assert tops.xcorr1d(f.bfloat16(), g).dtype == torch.bfloat16
    assert torch.equal(tops.xcorr1d(f.half(), g, strategy="elementwise",
                                    block_size=64, unroll=32),
                       ref.xcorr1d(f.half(), g))
    assert xcorr1d.xcorr1d_cuda.launches == 0


def test_launch_layout_by_hand():
    """Threads and shared bytes of one block, counted by hand from
    ``csrc/xcorr1d.cu``: min(block_size / U_e, 1024) threads (U_e the
    unroll on elementwise, else 1); the window of block_size + 2r inputs
    padded to 16 B, then 2r + 1 taps (the one-tile launch, which every
    strategy but register-tiled elementwise runs)."""
    L = xcorr1d.launch_threads
    assert L(2048, "baseline", 4, 3) == 1024  # two passes
    assert L(512, "baseline", 1, 3) == 512
    assert L(512, "pointwise", 7, 3) == 512  # unroll is along the taps
    assert L(2048, "elementwise", 4, 3) == 512
    assert L(4096, "elementwise", 2, 3) == 1024  # 2048 lanes: two passes
    assert L(100, "elementwise", 5, 3) == 20
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
    # B6b is ported: bf16 and f16, and any unroll, run; 2-byte windows
    # take half the bytes.
    xcorr1d.check_launch(3, 256, "baseline", 1, "bfloat16")
    xcorr1d.check_launch(3, 256, "pointwise", 17, "float32")
    xcorr1d.check_launch(3, 256, "baseline", 17, "float32")  # runs U = 1
    xcorr1d.check_launch(65, 2048, "elementwise", 64, "float16")
    with pytest.raises(ValueError, match="int32"):
        xcorr1d.check_launch(3, 256, "baseline", 1, "int32")
    assert S(3, 2048, "bfloat16") == 4112 + 3 * 2  # 2050 x 2 B -> 4112
    assert S(3, 2048, "float16", "pointwise", 64) == 4112 + 6
    # Unroll past 16 runs as its largest divisor of at most 16, in passes.
    R = xcorr1d.register_unroll
    assert [R(u) for u in (1, 7, 16, 17, 18, 24, 32, 48, 64, 100)] \
        == [1, 7, 16, 1, 9, 12, 16, 16, 16, 10]
    assert L(2048, "elementwise", 64, 3) == 32  # 64 outputs a thread
    assert L(2048, "pointwise", 64, 3) == 1024


def test_ring_layout_by_hand():
    """The ring's layout, counted by hand from ``csrc/xcorr1d.cu``: the
    empty-slot period (elementwise, U / V even with V filling 16 bytes),
    a window's bytes, the ring's stages (2 when two windows and the taps
    fit 227 KB), 16-byte staging (f on 16 bytes, tiles a multiple of 16
    bytes apart) and the persistent grid (at most the tiles); the route:
    the ring on elementwise at U > 1 from ``RING_MIN_TAPS`` taps, else
    the one-tile launch, a block a tile."""
    P = xcorr1d.window_pad
    assert [P("elementwise", u, "float32") for u in (1, 2, 4, 8, 12, 16)] \
        == [0, 0, 0, 2, 0, 4]
    assert [P("elementwise", u, "float64") for u in (1, 2, 4, 6, 8, 16)] \
        == [0, 0, 2, 0, 4, 8]
    assert P("pointwise", 8, "float32") == P("baseline", 16, "float64") == 0
    W = xcorr1d.window_bytes
    # r = 1024 f32 at block 2048: 4096 inputs, 1024 slots; U = 8 leaves
    # one empty after every 2 (511 more), U = 16 after every 4 (255).
    assert W(2049, 2048, "float32") == 16_384
    assert W(2049, 2048, "float32", "elementwise", 4) == 16_384
    assert W(2049, 2048, "float32", "elementwise", 8) == 16 * (1024 + 511)
    assert W(2049, 2048, "float32", "elementwise", 16) == 16 * (1024 + 255)
    assert W(2049, 2048, "float64", "elementwise", 8) == 16 * (2048 + 511)
    R = xcorr1d.ring_smem_bytes
    assert R(7, 2048, "float32", "elementwise", 4, 2) == 2 * 8224 + 28
    # U = 8: 256 threads, 8 warps of scratch, 32 x 3 slots each.
    assert R(2049, 2048, "float32", "elementwise", 8, 2) \
        == 2 * 24_560 + 8 * 32 * 3 * 16 + 2049 * 4
    assert xcorr1d.smem_bytes(2049, 2048, "float32", "elementwise", 8) \
        == R(2049, 2048, "float32", "elementwise", 8, 2)
    X = xcorr1d.warp_scratch_bytes
    assert [X("elementwise", u, "float32") for u in (1, 2, 3, 4, 6, 8, 16)] \
        == [0, 0, 32 * 3 * 4, 0, 32 * 6 * 4, 32 * 3 * 16, 32 * 5 * 16]
    assert [X("elementwise", u, "float64") for u in (1, 2, 3, 4, 12)] \
        == [0, 0, 32 * 3 * 8, 32 * 3 * 16, 32 * 7 * 16]
    assert X("pointwise", 8, "float32") == X("baseline", 1, "float64") == 0
    D = xcorr1d.ring_stages
    assert D(7, 2048, "float32", "elementwise", 4) == 2
    assert D(2049, 2048, "float64", "elementwise", 16) == 2
    assert D(2049, 24958, "float64", "baseline", 1) == 1  # one fits only
    # The register tiling's threads: at most 512 past U = 8 (the ring).
    L = xcorr1d.launch_threads
    assert L(16384, "elementwise", 8, 21) == 1024
    assert L(16384, "elementwise", 16, 21) == 512
    assert L(2048, "elementwise", 16, 21) == 128
    G = xcorr1d.launch_grid
    assert G(1 << 24, 21, 2048, "elementwise", 8, 132 * 4) == 528
    assert G(5000, 21, 2048, "elementwise", 8, 528) == 3
    assert G(1, 21, 2048, "elementwise", 8, 528) == 1
    # The ring is elementwise's at U > 1 from RING_MIN_TAPS = 21 taps;
    # else the one-tile launch: up to 1024 threads, one window and the
    # taps, a block a tile.
    assert xcorr1d.RING_MIN_TAPS == 21
    route = xcorr1d.ring_route
    assert [route("elementwise", 4, t) for t in (1, 7, 19, 20, 21, 2049)] \
        == [False, False, False, False, True, True]
    assert not route("elementwise", 1, 2049)
    assert not route("baseline", 1, 2049)
    assert not route("pointwise", 4, 2049)
    assert L(16384, "elementwise", 16, 19) == 1024
    assert L(16384, "elementwise", 1, 2049) == 1024
    assert xcorr1d.smem_bytes(19, 2048, "float32", "elementwise", 8) \
        == 8272 + 19 * 4  # 2066 x 4 B -> 8272
    assert xcorr1d.smem_bytes(2049, 2048, "float32", "pointwise", 8) \
        == 16_384 + 2049 * 4
    assert G(1 << 24, 19, 2048, "elementwise", 8, 528) == 8192
    assert G(1 << 24, 2049, 2048, "baseline", 1, 528) == 8192
    # 2-byte types: V = gcd(U_r, 8); U > 16 takes U_r's layout, its
    # threads block_size / U (each a few lanes of U_r outputs).
    assert [P("elementwise", u, "bfloat16") for u in (2, 4, 8, 12, 16)] \
        == [0, 0, 0, 0, 2]
    assert [P("elementwise", u, "float16") for u in (24, 32, 64)] \
        == [0, 2, 2]  # U_r 12, 16, 16
    assert P("elementwise", 32, "float32") == 4  # U_r 16
    assert W(2049, 2048, "bfloat16", "elementwise", 16) == 16 * (512 + 255)
    assert [X("elementwise", u, "float16") for u in (2, 4, 8, 12, 16, 64)] \
        == [0, 0, 0, 32 * 12 * 2, 32 * 3 * 16, 32 * 3 * 16]
    assert L(2048, "elementwise", 64, 2049) == 32
    assert L(65536, "elementwise", 32, 2049) == 512  # the ring's cap
    assert route("elementwise", 24, 21) and route("elementwise", 64, 2049)
    assert not route("elementwise", 17, 2049)  # U_r = 1: one-tile
    assert R(2049, 2048, "float16", "elementwise", 64, 2) \
        == 2 * 16 * (512 + 255) + 32 * 3 * 16 + 2049 * 2
    assert xcorr1d.ring_stages(2049, 2048, "bfloat16", "elementwise", 8) == 2
    f = torch.zeros(100, dtype=torch.float64)
    assert xcorr1d.wide_staging(f, 2048)
    assert not xcorr1d.wide_staging(f[1:], 2048)  # 8 bytes past 16
    assert not xcorr1d.wide_staging(f, 1001)  # tiles 8008 bytes apart
    assert xcorr1d.wide_staging(f.float(), 1000)  # 4000 bytes apart


def _slot(q, pad):
    return q + q // pad if pad else q


def _replay_elementwise(f, g, n, block_size, unroll, dtype):
    """``csrc/xcorr1d.cu``'s elementwise body replayed in numpy over all
    lanes of each tile at once: the window staged into its layout (16-byte
    slots, an empty one after every U / V vectors where the layout asks,
    past the tile's inputs zero, unstaged slots NaN), each lane's ring of U
    / V + 1 vectors loaded and read as the kernel does (the main loop of R
    groups, then the guarded last groups and the partial one), float64
    arithmetic, then the stores (:func:`_replay_stores`). Checks that every
    multiply-add of an output reads window element o + k for its tap k,
    taps in table order, and returns the outputs and how often each was
    written. U is the register width the kernel runs ``unroll`` at (a
    lane's outputs, ``register_unroll``; above 16 a thread takes several
    lanes); 2-byte types read element o + k of a lane's packed pair
    (o, o + 1) as element p of the group's window, p + 1 beside it (a
    register, or a byte permute of two), which the replay's element map
    holds."""
    item = xcorr1d.ITEMSIZE[dtype]
    vmax = 16 // item
    u = xcorr1d.register_unroll(unroll)
    v = math.gcd(u, vmax)
    nv = u // v
    ring_n = nv + 1
    pad = xcorr1d.window_pad("elementwise", u, dtype)
    n_taps = g.shape[0]
    win = block_size + n_taps - 1
    units = -(-win // vmax)
    q_end = -(-win // v)
    buf_len = xcorr1d.window_bytes(n_taps, block_size, dtype, "elementwise",
                                   u) // item
    out = np.full(n, np.nan)
    writes = np.zeros(n, np.int64)
    for tile in range(-(-n // block_size)):
        base = tile * block_size
        nout = min(n - base, block_size)
        avail = nout + n_taps - 1
        buf = np.full(buf_len, np.nan)
        i = np.arange(units * vmax)
        vals = np.zeros(units * vmax)
        vals[:avail] = f[base:base + avail]
        buf[_slot(i // vmax, pad) * vmax + i % vmax] = vals
        lanes = np.arange(block_size // u)
        lanes = lanes[lanes * u < nout]
        q0 = lanes * nv
        lw = lanes * (pad + 1) if pad else q0  # in V-element vectors

        def at(c):
            """(values, window element indices) of vector q0 + c."""
            idx = (lw + _slot(c, pad))[:, None] * v + np.arange(v)
            return buf[idx], (q0 + c)[:, None] * v + np.arange(v)

        ring = [None] * ring_n
        for j in range(nv):
            ring[j] = at(j)
        ring[nv] = (np.full((len(lanes), v), np.nan),
                    np.full((len(lanes), v), -1))
        acc = np.zeros((len(lanes), u))
        next_tap = np.zeros((len(lanes), u), np.int64)
        outs = lanes[:, None] * u + np.arange(u)

        def group(r, c, live):
            k0 = (c + r) * v
            for j in range(min(live, v)):
                k = k0 + j
                p = np.arange(u) + j
                vals = np.stack([ring[(r + pe // v) % ring_n][0][:, pe % v]
                                 for pe in p], axis=1)
                els = np.stack([ring[(r + pe // v) % ring_n][1][:, pe % v]
                                for pe in p], axis=1)
                assert (els == outs + k).all(), (r, c, j)
                assert (next_tap == k).all()
                next_tap[:] += 1
                acc[:] = acc + g[k] * vals

        c = 0
        while (c + ring_n) * v <= n_taps:
            for r in range(ring_n):
                ring[(r + nv) % ring_n] = at(c + r + nv)
                group(r, c, v)
            c += ring_n
        for r in range(ring_n):
            k0 = (c + r) * v
            if k0 < n_taps:
                keep = (q0 + c + r + nv) < q_end
                new_vals, new_els = at(np.minimum(c + r + nv,
                                                  q_end - 1 - q0))
                old_vals, old_els = ring[(r + nv) % ring_n]
                ring[(r + nv) % ring_n] = (
                    np.where(keep[:, None], new_vals, old_vals),
                    np.where(keep[:, None], new_els, old_els))
                group(r, c, n_taps - k0)
        assert (next_tap == n_taps).all()
        _replay_stores(out, writes, base, nout, lanes, acc, block_size, u,
                       v, pad, vmax, unroll)
    return out, writes


def _replay_stores(out, writes, base, nout, live_lanes, acc, block_size, u,
                   v, pad, vmax, unroll):
    """The kernel's stores of one tile: a lane's U outputs as one vector
    when U = V, else each warp's 32 U outputs through its scratch (a
    lane's vectors at lane (U/V + 1) + i with the empty slots, lane U/V +
    i without) and read back in output order, element e at slot(e / VMAX)
    VMAX + e % VMAX, by each lane of the warp (fewer than 32 in a part
    warp), 16 bytes at a time where the warp's first output sits on 16
    bytes, else element by element; past nout nothing is stored."""
    nv = u // v
    # the ring's threads (the register tiling runs on the ring only):
    # block_size / unroll, each taking lanes of u = U_r outputs
    threads = xcorr1d.launch_threads(block_size, "elementwise", unroll,
                                     xcorr1d.RING_MIN_TAPS)
    lanes = block_size // u
    vals = np.zeros((lanes, u))
    vals[live_lanes] = acc
    for l0 in range(0, lanes, threads):
        for warp0 in range(0, threads, 32):
            lane_ids = np.arange(l0 + warp0,
                                 l0 + warp0 + min(32, threads - warp0))
            if nv == 1:
                for l in lane_ids[(lane_ids < lanes)
                                  & (lane_ids * u < nout)]:
                    o = l * u + np.arange(u)
                    o = o[o < nout]
                    out[base + o] = vals[l, :len(o)]
                    np.add.at(writes, base + o, 1)
                continue
            per = 32 * (nv + 1 if pad else nv) * v
            scratch = np.full(per + vmax, np.nan)
            for lane, l in enumerate(lane_ids):
                if l < lanes and l * u < nout:
                    first = lane * (pad + 1) if pad else lane * nv
                    scratch[first * v:(first + nv) * v] = vals[l]
            w0 = (l0 + warp0) * u
            warp_lanes = len(lane_ids)
            end = min(nout, w0 + warp_lanes * u)
            aligned = (base + w0) * (16 // vmax) % 16 == 0
            for lane in range(warp_lanes):
                # each lane's stores, striding by the warp's lanes
                if aligned:
                    q = lane
                    while w0 + q * vmax < end:
                        e = q * vmax + np.arange(vmax)
                        e = e[w0 + e < end]
                        got = scratch[_slot(q, pad) * vmax + e % vmax]
                        assert not np.isnan(got).any()
                        out[base + w0 + e] = got
                        np.add.at(writes, base + w0 + e, 1)
                        q += warp_lanes
                else:
                    e = np.arange(lane, max(end - w0, 0), warp_lanes)
                    got = scratch[_slot(e // vmax, pad) * vmax + e % vmax]
                    assert not np.isnan(got).any()
                    out[base + w0 + e] = got
                    np.add.at(writes, base + w0 + e, 1)


@pytest.mark.parametrize("dtype", ("float32", "float64", "bfloat16",
                                   "float16"))
@pytest.mark.parametrize("radius", (0, 1, 3, 64, 1024))
@pytest.mark.parametrize("unroll", tuple(range(1, 17)) + WIDE_UNROLLS)
def test_register_tiling_replay(dtype, radius, unroll):
    """Every output written once, its taps summed in table order, each
    from window element o + k: the replay equals a plain float64 sum in
    tap order bit for bit, at a sampled block_size (a multiple of U; 1100
    lanes take the threads two or three passes, 37 leave a part warp) and
    a ragged n of two and a half tiles; 2-byte types and U past 16 (a
    thread several lanes of U_r) too."""
    rng = np.random.default_rng(100 * unroll + radius)
    block = unroll * int(rng.choice((3, 8, 37, 64, 1100)))
    n = 2 * block + block // 2 + 1
    f = rng.standard_normal(n + 2 * radius)
    g = rng.standard_normal(2 * radius + 1)
    got, writes = _replay_elementwise(f, g, n, block, unroll, dtype)
    assert (writes == 1).all()
    want = np.zeros(n)
    for k in range(g.shape[0]):
        want = want + g[k] * f[k:k + n]
    np.testing.assert_array_equal(got, want)


def _wavefronts(addresses, width):
    """Wavefronts of one shared-memory load of ``width`` bytes a thread at
    these 32 byte addresses: threads go in groups of 128 / width (all 32
    below 4 bytes, where threads in one 4-byte word share it), and a group
    takes as many wavefronts as the most distinct words one of its 4-byte
    banks holds."""
    per = min(32, 128 // width)
    total = 0
    for lo in range(0, 32, per):
        words = {a // 4 + b for a in addresses[lo:lo + per]
                 for b in range(max(width // 4, 1))}
        by_bank = collections.Counter(w % 32 for w in words)
        total += max(by_bank.values())
    return total


def _conflict_free(addresses, width):
    """Whether the load takes the fewest wavefronts (one per group)."""
    return _wavefronts(addresses, width) == -(-32 // min(32, 128 // width))


@pytest.mark.parametrize("dtype", ("float32", "float64", "bfloat16",
                                   "float16"))
@pytest.mark.parametrize("unroll", tuple(range(1, 17)) + WIDE_UNROLLS)
def test_register_tiling_loads_are_conflict_free(dtype, unroll):
    """Each window-vector load of a warp (its lanes' vector q0 + c, for
    every c a tap loop reaches) hits distinct banks, so a warp's V-element
    load takes the fewest wavefronts; without the empty slots, U = 8 and
    16 in f32, even U / 2 in f64 and U = 16 in 2-byte types would not (U
    the register width; past 16, U_r). 2-byte types at an odd U load one
    element at a time, U x 2 bytes apart: two wavefronts at most, the one
    case the layout leaves with conflicts (the packed pairs need an even
    U)."""
    item = xcorr1d.ITEMSIZE[dtype]
    unroll = xcorr1d.register_unroll(unroll)
    v = math.gcd(unroll, 16 // item)
    nv = unroll // v
    pad = xcorr1d.window_pad("elementwise", unroll, dtype)
    lanes = np.arange(32)
    lw = lanes * (pad + 1) if pad else lanes * nv
    odd_2byte = item == 2 and unroll % 2 == 1 and unroll > 1
    for c in range(4 * (nv + 1) + 3):
        addresses = ((lw + _slot(c, pad)) * v * item).tolist()
        if odd_2byte:
            assert _wavefronts(addresses, v * item) <= 2, c
        else:
            assert _conflict_free(addresses, v * item), c
    plain = (lanes * nv * v * item).tolist()
    assert _conflict_free(plain, v * item) == (pad == 0 and not odd_2byte)


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "float64", "bfloat16",
                                   "float16"))
@pytest.mark.parametrize("radius", (0, 1, 5, 32, 200, 1024))
@pytest.mark.parametrize("strategy,unroll", STRATEGY_UNROLL + [
    ("elementwise", 16), ("elementwise", 32), ("pointwise", 64)])
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
        (2049, 2048, "elementwise", 8, "float32"),
        (401, 100, "elementwise", 5, "float32"),
        (65, 1000, "pointwise", 7, "float64"),
        (2049, 2048, "elementwise", 64, "bfloat16"),
        (21, 1536, "elementwise", 24, "float16"),
        (7, 2048, "pointwise", 32, "float16"),
    ):
        assert xcorr1d.kernel_layout(n_taps, bs, strategy, u, dtype) == (
            xcorr1d.launch_threads(bs, strategy, u, n_taps),
            xcorr1d.smem_bytes(n_taps, bs, dtype, strategy, u),
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
    # B6b: bf16 and f16 steps are one launch each, equal to the plain step
    for half in (f.bfloat16(), f.half()):
        xcorr1d.reset_launch_counts()
        got = td.step_1d_xcorr(half, p, strategy="baseline")
        assert xcorr1d.xcorr1d_cuda.launches == 1
        assert torch.equal(got, td.step_1d_xcorr(half, p, strategy="hwc"))
