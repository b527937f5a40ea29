"""The 1-D kernels on the card: B6 (``csrc/xcorr1d.cu``) and B7
(``csrc/conv1d_depthwise.cu``) against their plain versions, and their
launch layouts against the kernels' own.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports nothing of JAX, so it runs on a machine with the
card and PyTorch alone (``tests/test_torch_xcorr.py`` and
``tests/test_torch_conv1d.py`` hold the port to the JAX package on the
CPU).

Tolerances: B6 within 1e-5 (f32) and 1e-12 (f64) of ``ref.xcorr1d``
relative to the largest |value| (the kernel's FMAs round once where the
plain version rounds twice), and in bf16 and f16 equal to it bit for bit
(a multiply and an add each rounded to the type, as the plain version
rounds them); B7 equal to ``ref.conv1d_depthwise`` bit for bit without
the SiLU (it rounds each product and partial sum to the input type, as
the plain version does), with it within 1e-5 (f32), 1e-12 (f64) and 2e-2
(bf16, f16) (an ``expf`` may differ by an ulp).
"""
import pytest
import torch

from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels import xcorr1d as kx

TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 2e-2,
       "float16": 2e-2}
DTYPES = ("float32", "float64", "bfloat16", "float16")


def _xcorr_close(got, want, dtype):
    """B6's outputs: bit for bit in the 2-byte types, else within TOL."""
    if got.element_size() == 2:
        assert torch.equal(got, want)
    else:
        assert _rel(got, want) <= TOL[dtype]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-300))


def _xcorr_inputs(n, radius, dtype, device, seed, offset=0):
    """(f_padded, g): f a view ``offset`` elements into a longer tensor
    (the same values at every offset)."""
    gen = torch.Generator().manual_seed(seed)
    f = torch.randn(n + 2 * radius, generator=gen, dtype=torch.float64)
    g = torch.randn(2 * radius + 1, generator=gen, dtype=torch.float64)
    dt = getattr(torch, dtype)
    buf = torch.zeros(n + 2 * radius + offset, dtype=dt, device=device)
    buf[offset:] = f.to(device, dt)
    return buf[offset:], g.to(device, dt)


# --- B6 ------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("radius", (0, 3, 64, 1024))
@pytest.mark.parametrize("unroll", (8, 16, 32, 64))
@pytest.mark.parametrize("offset", (0, 1))
def test_xcorr1d_unroll_sweep_on_card(cuda_device, dtype, radius, unroll,
                                      offset):
    """Elementwise at U = 8 and 16 (on the ring the register tiling's
    empty-slot layout) and at 32 and 64 (register passes of 16), up to r
    = 1024, on an f aligned to 16 bytes and on one an element past it
    (staged element by element), with a ragged last tile; r = 0 and 3
    take the one-tile launch."""
    n = (1 << 16) + 123
    f, g = _xcorr_inputs(n, radius, dtype, cuda_device, seed=radius,
                         offset=offset)
    assert kx.wide_staging(f, 2048) == (offset == 0)
    assert kx.ring_route("elementwise", unroll, 2 * radius + 1) \
        == (radius >= 64)
    kx.reset_launch_counts()
    got = tops.xcorr1d(f, g, strategy="elementwise", block_size=2048,
                       unroll=unroll)
    assert kx.xcorr1d_cuda.launches_by_strategy == {"elementwise": 1}
    _xcorr_close(got, ref.xcorr1d(f, g), dtype)


# (label, f's offset in elements, block_size by item size): 16-byte
# staging and two windows; element staging; a block whose two windows at
# r = 200 do not fit 227 KB (one window). Every unroll below divides the
# blocks.
XCORR_RINGS = (("two windows", 0, {4: 960, 8: 960, 2: 960}),
               ("element staging", 1, {4: 960, 8: 960, 2: 960}),
               ("one window", 0, {4: 30_000, 8: 14_400, 2: 57_600}))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("strategy,unroll", [
    ("elementwise", 1), ("elementwise", 2), ("elementwise", 3),
    ("elementwise", 4), ("elementwise", 5), ("elementwise", 6),
    ("elementwise", 12), ("elementwise", 15), ("elementwise", 24),
    ("pointwise", 7), ("pointwise", 24), ("baseline", 1)])
@pytest.mark.parametrize("ring", XCORR_RINGS, ids=lambda c: c[0])
def test_xcorr1d_tilings_and_rings_on_card(cuda_device, dtype, strategy,
                                           unroll, ring):
    """Every vector width of the register tiling (V = 1, 2, 4 in f32; 1,
    2 in f64; 1, 2, 4, 8 in 2-byte types, odd U element by element and
    even U in packed pairs), U = 24 as two passes of 12, the ring of two
    windows and of one, 16-byte and element staging, at r = 200 (the
    ring) and r = 5 (the one-tile launch; 2-byte types stage it by 16
    bytes where f is aligned)."""
    label, offset, blocks = ring
    block = blocks[kx.ITEMSIZE[dtype]]
    for radius in (5, 200):
        n = 40_000 + radius
        f, g = _xcorr_inputs(n, radius, dtype, cuda_device,
                             seed=unroll + radius, offset=offset)
        n_taps = 2 * radius + 1
        if kx.ring_route(strategy, unroll, n_taps):
            stages = kx.ring_stages(n_taps, block, dtype, strategy, unroll)
            assert stages == (1 if label == "one window" else 2)
            assert kx.wide_staging(f, block) == (offset == 0)
        got = kx.xcorr1d_cuda(f, g, strategy=strategy, block_size=block,
                              unroll=unroll)
        _xcorr_close(got, ref.xcorr1d(f, g), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("radius", (5, 64))
def test_xcorr1d_element_staging_equals_16_byte_staging(cuda_device, dtype,
                                                        radius):
    """The same values on an f aligned to 16 bytes and on one an element
    past it give the same bits, on the ring (r = 64, 16-byte staging
    against element staging) and on the one-tile launch (r = 5; in
    2-byte types staged by 16 bytes too where f is aligned)."""
    n = (1 << 15) + 7
    a_f, g = _xcorr_inputs(n, radius, dtype, cuda_device, seed=4)
    b_f, _ = _xcorr_inputs(n, radius, dtype, cuda_device, seed=4,
                           offset=1)
    assert torch.equal(a_f, b_f)
    assert kx.wide_staging(a_f, 2048) and not kx.wide_staging(b_f, 2048)
    for strategy, unroll in (("baseline", 1), ("elementwise", 8)):
        a = kx.xcorr1d_cuda(a_f, g, strategy=strategy, unroll=unroll)
        b = kx.xcorr1d_cuda(b_f, g, strategy=strategy, unroll=unroll)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_xcorr1d_layout_is_the_python_formula(cuda_device):
    for n, n_taps, bs, strategy, u, dtype in (
        (1 << 20, 3, 2048, "baseline", 4, "float32"),
        (1 << 20, 2049, 4096, "elementwise", 4, "float64"),
        (1 << 20, 2049, 2048, "elementwise", 8, "float32"),
        (1 << 20, 2049, 2048, "elementwise", 16, "float64"),
        (1000, 401, 100, "elementwise", 5, "float32"),
        (5000, 65, 1000, "pointwise", 7, "float64"),
        (1 << 16, 2049, 24958, "baseline", 1, "float64"),
        (1 << 20, 19, 16384, "elementwise", 16, "float32"),
        (1 << 20, 21, 16384, "elementwise", 16, "float32"),
        (1 << 20, 2049, 16384, "elementwise", 1, "float32"),
        (12345, 16, 1000, "pointwise", 3, "float64"),
        (1 << 20, 2049, 2048, "elementwise", 16, "bfloat16"),
        (1 << 20, 65, 2048, "elementwise", 64, "float16"),
        (1 << 20, 7, 2048, "elementwise", 32, "bfloat16"),
        (1 << 20, 2049, 1536, "elementwise", 24, "float64"),
        (1 << 20, 21, 1536, "elementwise", 3, "float16"),
        (5000, 65, 1000, "pointwise", 40, "float16"),
    ):
        assert kx.kernel_layout(n_taps, bs, strategy, u, dtype) == (
            kx.launch_threads(bs, strategy, u, n_taps),
            kx.smem_bytes(n_taps, bs, dtype, strategy, u),
        )
        _, fields = kx.layout_fields(n_taps, bs, strategy, u, dtype)
        ku = kx.kernel_unroll(strategy, u)
        assert (fields["unroll"], fields["passes"]) == (
            kx.register_unroll(ku), ku // kx.register_unroll(ku))
        resident = kx.kernel_grid(0, n_taps, bs, strategy, u, dtype)
        if kx.ring_route(strategy, u, n_taps):
            assert resident >= torch.cuda.get_device_properties(
                cuda_device).multi_processor_count
        assert kx.kernel_grid(n, n_taps, bs, strategy, u, dtype) \
            == kx.launch_grid(n, n_taps, bs, strategy, u, resident)


# --- B7 ------------------------------------------------------------------------


def _conv_inputs(shape, k, dtype, device, seed, row=None, offset=0,
                 stride_pad=0):
    """(x, w): x (b, s, c) a column view of a (b, s, row) tensor at
    ``offset`` (or its own contiguous tensor), or with ``stride_pad`` a
    view whose rows are c + stride_pad apart."""
    b, s, c = shape
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    width = row or c + stride_pad
    full = torch.randn((b, s, width), generator=gen).to(device, dt)
    x = full[..., offset:offset + c]
    w = torch.randn((k, c), generator=gen).to(device, dt)
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ("none", "silu"))
@pytest.mark.parametrize("k", tuple(range(1, kc.MAX_K + 1)) + (9, 16, 33))
@pytest.mark.parametrize("view", [
    dict(shape=(2, 300, 3328), row=6448, offset=3072),  # xBC: 16-byte lanes
    dict(shape=(2, 300, 3328), row=6448, offset=3073),  # 2-byte aligned
    dict(shape=(2, 300, 3328), row=6448, offset=3074),  # 2-byte pairs
    dict(shape=(3, 257, 100)),                          # c % 8 != 0
    dict(shape=(2, 129, 64), stride_pad=3),             # odd row stride
    dict(shape=(1, 70, 33), stride_pad=1),              # odd c and stride
])
def test_conv1d_views_on_card(cuda_device, dtype, activation, k, view):
    view = dict(view)
    shape = view.pop("shape")
    x, w = _conv_inputs(shape, k, dtype, cuda_device, seed=k, **view)
    kc.reset_launch_counts()
    got = tops.conv1d_depthwise(x, w, activation=activation)
    assert kc.conv1d_depthwise_cuda.launches == 1
    want = ref.conv1d_depthwise(x, w, activation)
    assert got.is_contiguous() and got.shape == x.shape
    if activation == "none":
        assert torch.equal(got, want)
    else:
        assert _rel(got, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1d_every_width_equals_the_plain_version(cuda_device, dtype):
    """The same input placed 0, 2 and 1 channels into a wider row takes
    the 16-byte lanes, 2-byte pairs (f32: single channels; f64: 16-byte
    lanes again) and single channels; each equals the plain version bit
    for bit."""
    x0, w = _conv_inputs((2, 1000, 256), 4, dtype, cuda_device, seed=9)
    want = ref.conv1d_depthwise(x0, w)
    widths = {"bfloat16": {0: 8, 2: 2, 1: 1}, "float16": {0: 8, 2: 2, 1: 1},
              "float32": {0: 4, 2: 1, 1: 1},
              "float64": {0: 2, 2: 2, 1: 1}}[dtype]
    for offset, vec in widths.items():
        full = torch.zeros((2, 1000, 264), dtype=x0.dtype,
                           device=cuda_device)
        full[..., offset:offset + 256] = x0
        x = full[..., offset:offset + 256]
        assert kc.vector_width(x, w) == vec
        assert torch.equal(kc.conv1d_depthwise_cuda(x, w), want)


@pytest.mark.cuda
def test_conv1d_layout_is_the_python_formula(cuda_device):
    assert kc.kernel_threads() == kc.THREADS
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for b, s, c, k, act, dtype, vec in (
        (4, 8192, 3328, 4, "none", "bfloat16", 8),
        (4, 8192, 3328, 4, "none", "float32", 4),
        (4, 8192, 3328, 4, "silu", "bfloat16", 2),
        (1, 64, 8, 4, "none", "float32", 1),
        (2, 513, 64, 8, "silu", "bfloat16", 1),
        (4, 8192, 3328, 4, "none", "float16", 8),
        (4, 8192, 3328, 4, "silu", "float64", 2),
        (2, 513, 64, 33, "none", "float16", 2),
        (2, 513, 64, 16, "silu", "float64", 1),
    ):
        resident = kc.kernel_grid(0, 0, 0, k, act, dtype, vec)
        assert resident >= sms
        assert kc.kernel_grid(b, s, c, k, act, dtype, vec) == \
            kc.launch_layout(b, s, c, vec, resident)[0]
        _, fields = kc.layout_fields(b, s, c, k, vec)
        assert fields["taps"] == kc.tap_body(k)
    # B7b: float16 with float32 taps (cast once) launches the kernel.
    kc.reset_launch_counts()
    x16 = torch.ones(1, 8, 4, device=cuda_device, dtype=torch.float16)
    w32 = torch.ones(4, 4, device=cuda_device)
    got = tops.conv1d_depthwise(x16, w32)
    assert kc.conv1d_depthwise_cuda.launches == 1
    assert torch.equal(got, ref.conv1d_depthwise(x16, w32))
