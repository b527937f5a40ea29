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
and an add), 2e-2 in bfloat16 (XLA on the CPU may keep a sum in float32
between ops where PyTorch rounds each op to bfloat16). On the card the
kernel rounds each product and each partial sum to the input type, as
the plain version does: without the SiLU it equals the plain version bit
for bit; with it, within 1e-5 relative to the largest |value| in float32
and 2e-2 in bfloat16 (an ``expf`` may differ by an ulp).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [(1, 64, 8, 4), (3, 100, 16, 4), (2, 257, 32, 7)]  # (b, s, c, k)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(bsck, dtype, seed=0):
    """(jax x, jax w, torch x, torch w): standard normal draws, the same
    values (bf16 rounded once, by JAX, then carried across exactly)."""
    b, s, c, k = bsck
    rng = np.random.default_rng(seed)
    xj = jnp.asarray(rng.standard_normal((b, s, c)), JDT[dtype])
    wj = jnp.asarray(rng.standard_normal((k, c)), JDT[dtype])

    def to_torch(a):
        return torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])

    return xj, wj, to_torch(xj), to_torch(wj)


def _close(got: torch.Tensor, want, dtype: str) -> None:
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
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


def test_rules_name_their_roadmap_items():
    x, w = torch.zeros(1, 8, 4), torch.zeros(4, 4)
    with pytest.raises(NotImplementedError, match="A9"):
        tops.conv1d_depthwise(x, w, block_seq="auto")
    with pytest.raises(ValueError, match="activation"):
        tops.conv1d_depthwise(x, w, activation="gelu")
    with pytest.raises(ValueError, match=r"\(k, c\)"):
        tops.conv1d_depthwise(x, torch.zeros(4, 5))
    for dtype in ("float16", "float64"):
        with pytest.raises(NotImplementedError, match="B7b"):
            kc.check_launch(1, 8, 4, 4, 512, dtype)
    with pytest.raises(NotImplementedError, match="B7b"):
        kc.check_launch(1, 8, 4, kc.MAX_K + 1, 512, "float32")
    kc.check_launch(1, 8, 4, kc.MAX_K, 512, "bfloat16")
    # 65,535 runs of one position fit the grid; one more does not.
    kc.check_launch(1, 65_535, 4, 4, 1, "float32")
    with pytest.raises(ValueError, match="grid"):
        kc.check_launch(1, 65_536, 4, 4, 1, "float32")
    # None is the reference's 512; the CPU takes any float dtype (the
    # plain version), as the reference does.
    x64 = torch.randn(1, 8, 4, dtype=torch.float64)
    w64 = torch.randn(4, 4, dtype=torch.float64)
    assert torch.equal(tops.conv1d_depthwise(x64, w64, block_seq=None),
                       ref.conv1d_depthwise(x64, w64))


def test_launch_layout_by_hand():
    """Grid and threads, counted by hand from ``csrc/conv1d_depthwise.cu``:
    ceil(c / vec) lanes in whole warps of at most 128 threads along x,
    ceil(s / block_seq) runs along y, the batch along z."""
    L = kc.launch_layout
    # mamba2-780m's prefill launch: c = 3072 + 2·128 = 3328 channels.
    assert L(4, 8192, 3328, 512, 2) == ((13, 16, 4), 128)  # bf16 pairs
    assert L(4, 8192, 3328, 512, 1) == ((26, 16, 4), 128)  # f32
    assert L(4, 8193, 3328, 512, 2) == ((13, 17, 4), 128)  # ragged run
    assert L(1, 64, 8, 128, 1) == ((1, 1, 1), 32)
    assert L(3, 100, 16, 128, 2) == ((1, 1, 3), 32)
    assert L(2, 257, 33, 128, 1) == ((1, 3, 2), 64)
    assert L(2, 512, 160, 512, 1) == ((2, 1, 2), 128)  # reduced mamba2
    V = kc.vector_width
    proj = torch.zeros(4, 16, 6448, dtype=torch.bfloat16)
    w = torch.zeros(4, 3328, dtype=torch.bfloat16)
    assert V(proj[..., 3072:6400], w) == 2  # xBC: rows 6448 apart
    assert V(proj[..., 3073:6401], w) == 1  # starts on 2 bytes
    assert V(proj[..., 3072:6399], w[:, :3327]) == 1  # odd channel count
    assert V(proj.float()[..., 3072:6400], w.float()) == 1  # f32


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
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("bsck", SHAPES + [(2, 1000, 130, 1), (2, 513, 64, 8)])
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
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_kernel_on_strided_view_matches_plain_on_card(cuda_device, dtype):
    g = torch.Generator().manual_seed(7)
    proj = torch.randn(2, 300, 6448, generator=g).to(cuda_device, TDT[dtype])
    for lo in (3072, 3073):  # bf16: two channels per thread, then one
        xbc = proj[..., lo : lo + 3328]
        w = torch.randn(4, 3328, generator=g).to(cuda_device, TDT[dtype])
        got = tops.conv1d_depthwise(xbc, w)
        assert torch.equal(got, tops.conv1d_depthwise(xbc.contiguous(), w))
        assert torch.equal(got, ref.conv1d_depthwise(xbc, w))


@pytest.mark.cuda
def test_kernel_threads_are_the_python_formula(cuda_device):
    for c, vec in ((3328, 2), (3328, 1), (8, 1), (33, 1), (130, 2)):
        assert kc.kernel_threads(c, vec) == kc.launch_layout(1, 1, c, 1, vec)[1]
    with pytest.raises(NotImplementedError, match="B7b"):
        tops.conv1d_depthwise(torch.zeros(1, 8, 4, device=cuda_device,
                                          dtype=torch.float16),
                              torch.zeros(4, 4, device=cuda_device))
