"""mamba2's depthwise causal conv1d in the port (``ref.conv1d_depthwise*``,
``ops.conv1d_depthwise``, B7 ``csrc/conv1d_depthwise.cu``) against the
JAX package.

The JAX side runs as ``tests/test_kernels.py:114-128`` runs it:
``ops.conv1d_depthwise(..., interpret=True, block_seq=128)`` (the Pallas
kernel in interpret mode) and ``repro.kernels.ref``. Inputs are numpy
draws from a seed handed to both packages. On the CPU the port's wrapper
takes its plain version, so these tests hold the port's dispatch, rules
and plain arithmetic to the reference; tests marked ``cuda`` hold the
CUDA kernel to that plain version and skip without a card.

Tolerances are the reference's own (``test_kernels.py:125``), per
element as ``assert_allclose(rtol=tol, atol=tol)``: 1e-5 in float32
(both sum the same k terms in the same order; XLA may fuse a multiply
and an add), 2e-2 in bfloat16 and float16 (XLA on the CPU may keep a sum
in float32 between ops where PyTorch rounds each op to the type; in
float16 at k = 4-33 the largest distance seen was 1.3e-3 of the largest
|value|, at k = 33), 1e-12 in float64 (the same terms in the same
order; 4e-16 seen). On the card the kernel rounds each
product and each partial sum to the input type, as the plain version
does: without the SiLU it equals the plain version bit for bit; with it,
within 1e-5 relative to the largest |value| in float32, 1e-12 in float64
and 2e-2 in bfloat16 and float16 (an ``expf`` may differ by an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2,
       "float64": 1e-12}
SHAPES = [(1, 64, 8, 4), (3, 100, 16, 4), (2, 257, 32, 7)]  # (b, s, c, k)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16, "float64": jnp.float64}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16, "float64": torch.float64}
# B7b: float16 and float64, and tap counts past the kernel's templated
# MAX_K = 8 (its body with k at run time), beside the reference's 4 and 7.
B7B_TAPS = (4, 7, 9, 16, 33)


def _inputs(bsck, dtype, seed=0):
    """(jax x, jax w, torch x, torch w): standard normal draws, the same
    values (rounded once, by JAX, then carried across exactly)."""
    b, s, c, k = bsck
    rng = np.random.default_rng(seed)
    xj = jnp.asarray(rng.standard_normal((b, s, c)), JDT[dtype])
    wj = jnp.asarray(rng.standard_normal((k, c)), JDT[dtype])

    def to_torch(a):
        if dtype == "bfloat16":
            return torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])
        return torch.from_numpy(np.array(a))

    return xj, wj, to_torch(xj), to_torch(wj)


def _close(got: torch.Tensor, want, dtype: str) -> None:
    np.testing.assert_allclose(
        got.double().numpy(), np.asarray(want, np.float64),
        rtol=TOL[dtype], atol=TOL[dtype],
    )


# --- the port against JAX ------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("bsck", SHAPES)
def test_ref_matches_jax_ref(dtype, bsck):
    xj, wj, xt, wt = _inputs(bsck, dtype)
    got = ref.conv1d_depthwise_causal(xt, wt)
    assert got.shape == xt.shape and got.dtype == TDT[dtype]
    _close(got, jref.conv1d_depthwise_causal(xj, wj), dtype)


@pytest.mark.parametrize("activation", ("none", "silu"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("bsck", SHAPES)
def test_ops_matches_jax_interpret(dtype, bsck, activation):
    """The reference's sweep (``test_kernels.py:114``), with and without
    the fused SiLU."""
    xj, wj, xt, wt = _inputs(bsck, dtype, seed=bsck[1])
    want = jops.conv1d_depthwise(xj, wj, activation=activation,
                                 interpret=True, block_seq=128)
    got = tops.conv1d_depthwise(xt, wt, activation=activation,
                                block_seq=128)
    assert got.shape == xt.shape and got.dtype == TDT[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("activation", ("none", "silu"))
@pytest.mark.parametrize("k", B7B_TAPS)
@pytest.mark.parametrize("dtype", ("float16", "float64"))
def test_b7b_types_and_taps_match_jax_interpret(dtype, k, activation):
    """float16 and float64 at k = 4-33 (past the kernel's templated 8),
    with and without the SiLU, against the Pallas kernel in interpret
    mode: float64 within 1e-12, float16 within 2e-2 (largest distance
    seen 1.3e-3 of the largest |value|, at k = 33: XLA keeps some sums
    wider)."""
    with jax.enable_x64(True):
        xj, wj, xt, wt = _inputs((2, 100, 16, k), dtype, seed=k)
        want = jops.conv1d_depthwise(xj, wj, activation=activation,
                                     interpret=True, block_seq=128)
        got = tops.conv1d_depthwise(xt, wt, activation=activation,
                                    block_seq=128)
        assert got.shape == xt.shape and got.dtype == TDT[dtype]
        _close(got, want, dtype)
        _close(ref.conv1d_depthwise_causal(xt, wt),
               jref.conv1d_depthwise_causal(xj, wj), dtype)


def test_float64_weights_round_once_to_float16():
    """A float64 ``w`` on a float16 ``x`` is rounded once, as JAX's
    ``astype`` and numpy round it (torch's own cast goes through float32;
    the seeded draw holds values where the two differ). With x a unit
    impulse at t = 0, output t is tap 3 - t alone."""
    rng = np.random.default_rng(11)
    w64 = rng.standard_normal((4, 50_000))
    once = w64.astype(np.float16).view(np.uint16)
    twice = torch.from_numpy(w64).to(torch.float16).numpy().view(np.uint16)
    assert (twice != once).any()
    x = torch.zeros(1, 4, 50_000, dtype=torch.float16)
    x[0, 0] = 1
    for y in (ref.conv1d_depthwise_causal(x, torch.from_numpy(w64)),
              tops.conv1d_depthwise(x, torch.from_numpy(w64))):
        for t in range(4):
            np.testing.assert_array_equal(y[0, t].numpy().view(np.uint16),
                                          once[3 - t])


def test_strided_xbc_view_matches_a_contiguous_copy():
    """mamba2's xBC: a column slice of the in-projection, rows 2·d_inner
    + 2·g·n + h apart, goes in as it is and gives what its copy gives."""
    rng = np.random.default_rng(3)
    proj = torch.from_numpy(rng.standard_normal((2, 40, 100))).float()
    xbc = proj[..., 30:94]
    w = torch.from_numpy(rng.standard_normal((4, 64))).float()
    assert not xbc.is_contiguous()
    got = tops.conv1d_depthwise(xbc, w)
    assert got.is_contiguous()
    assert torch.equal(got, tops.conv1d_depthwise(xbc.contiguous(), w))
    want = jops.conv1d_depthwise(jnp.asarray(xbc.numpy()),
                                 jnp.asarray(w.numpy()), interpret=True)
    _close(got, want, "float32")


# --- rules and layout ----------------------------------------------------------


def test_rules_name_their_roadmap_items(tmp_path, monkeypatch):
    x, w = torch.zeros(1, 8, 4), torch.zeros(4, 4)
    # block_seq="auto" (the tuner, ROADMAP A9, ported) resolves to the
    # default, B7's launch not depending on it, and equals it.
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path))
    xr = torch.randn(1, 8, 4, generator=torch.Generator().manual_seed(1))
    assert torch.equal(tops.conv1d_depthwise(xr, w + 1, block_seq="auto"),
                       tops.conv1d_depthwise(xr, w + 1))
    with pytest.raises(ValueError, match="activation"):
        tops.conv1d_depthwise(x, w, activation="gelu")
    with pytest.raises(ValueError, match=r"\(k, c\)"):
        tops.conv1d_depthwise(x, torch.zeros(4, 5))
    # B7b is ported: every float dtype and any k >= 1 (past MAX_K the
    # kernel's body with k at run time).
    for dtype in ("float16", "float64"):
        kc.check_launch(1, 8, 4, 4, 512, dtype)
    kc.check_launch(1, 8, 4, kc.MAX_K + 1, 512, "float32")
    kc.check_launch(1, 8, 4, 33, 512, "float16")
    kc.check_launch(1, 8, 4, kc.MAX_K, 512, "bfloat16")
    assert [kc.tap_body(k) for k in (1, 8, 9, 33)] == [1, 8, 0, 0]
    with pytest.raises(ValueError, match="int32"):
        kc.check_launch(1, 8, 4, 4, 512, "int32")
    with pytest.raises(ValueError, match="tap"):
        kc.check_launch(1, 8, 4, 0, 512, "float16")
    # The persistent grid splits the positions itself, so runs of one
    # position past CUDA's 65,535 grid rows fit; block_seq must be a
    # positive int.
    kc.check_launch(1, 65_535, 4, 4, 1, "float32")
    kc.check_launch(70_000, 65_536, 4, 4, 1, "float32")
    with pytest.raises(ValueError, match="block_seq"):
        kc.check_launch(1, 8, 4, 4, 0, "float32")
    # None is the reference's 512; the CPU takes any float dtype (the
    # plain version), as the reference does.
    x64 = torch.randn(1, 8, 4, dtype=torch.float64)
    w64 = torch.randn(4, 4, dtype=torch.float64)
    assert torch.equal(tops.conv1d_depthwise(x64, w64, block_seq=None),
                       ref.conv1d_depthwise(x64, w64))


def test_launch_layout_by_hand():
    """Grid and threads, counted by hand from ``csrc/conv1d_depthwise.cu``:
    256 threads (8 warps); the (warp column, batch, position) space of
    ceil(ceil(c / vec) / 32) columns, b sequences and s positions; blocks
    for one warp per 32 positions, at least 1, at most the resident
    blocks (132 SMs x 3 here)."""
    L = kc.launch_layout
    resident = 132 * 3
    # mamba2-780m's prefill launch: c = 3072 + 2·128 = 3328 channels,
    # 416 lanes of 8 bf16 (13 columns) or 832 of 4 f32 (26).
    assert kc.positions(4, 8192, 3328, 8) == 13 * 4 * 8192
    assert L(4, 8192, 3328, 8, resident) == (resident, 256)  # bf16 lanes
    assert L(4, 8192, 3328, 4, resident) == (resident, 256)  # f32
    assert kc.positions(4, 8192, 3328, 2) == 52 * 4 * 8192  # bf16 pairs
    assert L(1, 64, 8, 1, resident) == (1, 256)  # 64 positions: 1 block
    assert L(3, 100, 16, 2, resident) == (2, 256)  # 300 positions
    assert L(2, 257, 33, 1, resident) == (5, 256)  # 2 columns, 1028
    assert L(2, 512, 160, 4, resident) == (8, 256)  # reduced: 2 columns
    assert L(2, 512, 160, 4, 3) == (3, 256)  # at most the resident blocks
    assert kc.THREADS == 256 and kc.WARPS == 8
    V = kc.vector_width
    proj = torch.zeros(4, 16, 6448, dtype=torch.bfloat16)
    w = torch.zeros(4, 3328, dtype=torch.bfloat16)
    assert V(proj[..., 3072:6400], w) == 8  # xBC: rows 6448 apart
    assert V(proj[..., 3074:6402], w) == 2  # starts on 4, not 16, bytes
    assert V(proj[..., 3073:6401], w) == 1  # starts on 2 bytes
    assert V(proj[..., 3072:6398], w[:, :3326]) == 2  # c % 8 = 6
    assert V(proj[..., 3072:6399], w[:, :3327]) == 1  # odd channel count
    assert V(proj.float()[..., 3072:6400], w.float()) == 4  # f32
    assert V(proj.float()[..., 3074:6402], w.float()) == 1  # 8-byte start
    # float16 as bfloat16; float64 two channels a 16-byte lane
    assert V(proj.half()[..., 3072:6400], w.half()) == 8
    assert V(proj.half()[..., 3074:6402], w.half()) == 2
    assert V(proj.half()[..., 3073:6401], w.half()) == 1
    assert V(proj.double()[..., 3072:6400], w.double()) == 2
    assert V(proj.double()[..., 3073:6401], w.double()) == 1
    assert kc.positions(4, 8192, 3328, 2) == 52 * 4 * 8192  # f64 lanes


@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16",
                                   "float64"))
@pytest.mark.parametrize("row,offset,c,widths", [
    (6448, 3072, 3328, (4, 8, 2)),  # the xBC view: 16-byte lanes
    (6447, 3072, 3328, (1, 1, 1)),  # odd row stride
    (6448, 3076, 3328, (4, 2, 2)),  # starts on 16 B in f32, on 8 B in bf16
    (6448, 3072, 3320, (4, 8, 2)),  # c a multiple of 8, not of 32 lanes x 8
    (6448, 3072, 3322, (1, 2, 2)),  # c % 8 = 2 (c % 4 = 2)
])
def test_vector_width_on_xbc_like_views(dtype, row, offset, c, widths):
    """The 16-byte choice needs c and both outer strides to be multiples
    of 16 bytes' channels and x and w to start on 16 bytes; a 2-byte type
    falls to pairs where they are even and 4-byte aligned, else to one
    channel, as before. ``widths`` is (float32, bfloat16 and float16,
    float64)."""
    dt = getattr(torch, dtype)
    x = torch.zeros(2, 5, row, dtype=dt)[..., offset:offset + c]
    w = torch.zeros(4, c, dtype=dt)
    assert x.data_ptr() % 16 == (offset * x.element_size()) % 16
    which = {"float32": 0, "bfloat16": 1, "float16": 1, "float64": 2}
    assert kc.vector_width(x, w) == widths[which[dtype]]


def _replay(x, w, vec, grid):
    """The kernel's walk replayed with the plain version's arithmetic:
    each warp's runs (``kc.warp_runs``), each lane's ``vec`` channels, a
    halo of k - 1 inputs before each run (zeros before the sequence).
    Returns the output and how often each (b, t, c) was written."""
    b, s, c = x.shape
    k = w.shape[0]
    y = torch.zeros((b, s, c), dtype=x.dtype)
    writes = torch.zeros((b, s, c), dtype=torch.int32)
    for _, col, bi, t0, t1 in kc.warp_runs(b, s, c, vec, grid):
        lo = col * 32 * vec
        hi = min(c, lo + 32 * vec)
        if lo >= c:
            continue
        pad = torch.zeros((k - 1, hi - lo), dtype=x.dtype)
        xs = torch.cat([pad, x[bi, :, lo:hi]])[t0:t1 + k - 1]
        acc = w[0, lo:hi] * xs[0:t1 - t0]
        for j in range(1, k):
            acc = acc + w[j, lo:hi] * xs[j:j + t1 - t0]
        y[bi, t0:t1, lo:hi] = acc
        writes[bi, t0:t1, lo:hi] += 1
    return y, writes


@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16",
                                   "float64"))
@pytest.mark.parametrize("shape,k,row,offset,resident", [
    ((2, 300, 264), 4, 520, 256, 7),   # strided view, grid at the resident cap
    ((3, 77, 100), 7, None, 0, 50),    # c % 8 != 0
    ((1, 2000, 33), 1, 34, 1, 3),      # odd c, 3 blocks: runs past sequences
    ((4, 40, 512), 8, None, 0, 1000),  # more warps than 32 positions each
    ((2, 90, 48), 33, None, 0, 5),     # k at run time: halos past the run
])
def test_warp_runs_cover_each_output_once(dtype, shape, k, row, offset,
                                          resident):
    """The persistent split covers every (b, t, c) exactly once, each
    warp's share within one position of the others', and the replayed
    walk (a halo before each run) equals the plain version bit for
    bit."""
    b, s, c = shape
    rng = np.random.default_rng(s)
    dt = TDT[dtype]
    full = torch.from_numpy(rng.standard_normal((b, s, row or c))).to(dt)
    x = full[..., offset:offset + c]
    w = torch.from_numpy(rng.standard_normal((k, c))).to(dt)
    vec = kc.vector_width(x, w)
    grid, threads = kc.launch_layout(b, s, c, vec, resident)
    shares = {}
    for warp, _, _, t0, t1 in kc.warp_runs(b, s, c, vec, grid):
        shares[warp] = shares.get(warp, 0) + t1 - t0
    assert sum(shares.values()) == kc.positions(b, s, c, vec)
    assert max(shares.values()) - min(shares.values(), default=0) <= 1 \
        or len(shares) < grid * threads // 32
    y, writes = _replay(x, w, vec, grid)
    assert bool((writes == 1).all())
    assert torch.equal(y, ref.conv1d_depthwise(x, w))


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ("none", "silu"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16",
                                   "float64"))
@pytest.mark.parametrize("bsck", SHAPES + [(2, 1000, 130, 1), (2, 513, 64, 8),
                                           (2, 300, 64, 9), (2, 300, 40, 16),
                                           (2, 300, 72, 33)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, bsck, activation):
    b, s, c, k = bsck
    g = torch.Generator().manual_seed(s)
    x = torch.randn(b, s, c, generator=g).to(cuda_device, TDT[dtype])
    w = torch.randn(k, c, generator=g).to(cuda_device, TDT[dtype])
    kc.reset_launch_counts()
    got = tops.conv1d_depthwise(x, w, activation=activation, block_seq=128)
    assert kc.conv1d_depthwise_cuda.launches == 1
    want = ref.conv1d_depthwise(x, w, activation)
    assert _rel(got, want) <= TOL[dtype]
    if activation == "none":
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16",
                                   "float64"))
@pytest.mark.parametrize("k", (4, 16))
def test_kernel_on_strided_view_matches_plain_on_card(cuda_device, dtype, k):
    g = torch.Generator().manual_seed(7)
    proj = torch.randn(2, 300, 6448, generator=g).to(cuda_device, TDT[dtype])
    for lo in (3072, 3074, 3073):  # 16-byte lanes, 2-byte pairs, single
        xbc = proj[..., lo : lo + 3328]
        w = torch.randn(k, 3328, generator=g).to(cuda_device, TDT[dtype])
        got = tops.conv1d_depthwise(xbc, w)
        assert torch.equal(got, tops.conv1d_depthwise(xbc.contiguous(), w))
        assert torch.equal(got, ref.conv1d_depthwise(xbc, w))


@pytest.mark.cuda
def test_kernel_threads_are_the_python_formula(cuda_device):
    assert kc.kernel_threads() == kc.THREADS
    for b, s, c, vec in ((4, 8192, 3328, 8), (4, 8192, 3328, 4),
                         (1, 64, 8, 1), (2, 257, 33, 1), (3, 100, 130, 2)):
        dtype = "float32" if vec == 4 else "bfloat16"
        resident = kc.kernel_grid(0, 0, 0, 4, "none", dtype, vec)
        assert kc.kernel_grid(b, s, c, 4, "none", dtype, vec) == \
            kc.launch_layout(b, s, c, vec, resident)[0]
    # B7b: float16 (w float32, cast once) and k past MAX_K launch once.
    kc.reset_launch_counts()
    x16 = torch.ones(1, 8, 4, device=cuda_device, dtype=torch.float16)
    got = tops.conv1d_depthwise(x16, torch.ones(12, 4, device=cuda_device))
    assert kc.conv1d_depthwise_cuda.launches == 1
    assert torch.equal(got, ref.conv1d_depthwise(
        x16, torch.ones(12, 4, device=cuda_device)))
    for b, s, c, k, vec, dtype in ((4, 8192, 3328, 4, 8, "float16"),
                                   (4, 8192, 3328, 4, 2, "float64"),
                                   (2, 300, 72, 33, 8, "bfloat16")):
        resident = kc.kernel_grid(0, 0, 0, k, "none", dtype, vec)
        assert kc.kernel_grid(b, s, c, k, "none", dtype, vec) == \
            kc.launch_layout(b, s, c, vec, resident)[0]
