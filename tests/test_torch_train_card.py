"""Training on the card: B7 (``csrc/conv1d_depthwise.cu``) under autograd
(``conv1d_depthwise.Conv1dDepthwise``) against the plain version's
autograd, and the reduced mamba2's train step through it.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports nothing of JAX, so it runs on a machine with the
card and PyTorch alone (``tests/test_torch_train.py`` holds the port to
the JAX package on the CPU).

Tolerances: the forward equal to ``ref.conv1d_depthwise`` bit for bit
(the kernel rounds each product and partial sum to the input type, as
the plain version does, ``tests/test_torch_1d_card.py``); the gradients
too, since the backward is the plain version's gradient on the same
saved inputs and the same upstream gradient.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data import MarkovLMDataset
from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.launch.steps import make_grad_step, make_train_step
from repro_torch.models import ssm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves_with_path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _xbc(shape, row, offset, dtype, device, seed=0):
    """A column view (b, s, c) at ``offset`` of a (b, s, row) leaf that
    requires a gradient (mamba2's xBC in its in-projection), taps
    (4, c), and an upstream gradient, in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    b, s, c = shape
    base = torch.randn((b, s, row), generator=gen).to(device, dtype)
    w = torch.randn((4, c), generator=gen).to(device, dtype)
    gy = torch.randn(shape, generator=gen).to(device, dtype)
    return base.requires_grad_(), w.requires_grad_(), gy


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ("none", "silu"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_conv1d_function_on_card_equals_plain_autograd(cuda_device, dtype,
                                                       activation):
    base, w, gy = _xbc((2, 300, 104), 232, 96, getattr(torch, dtype),
                       cuda_device)
    kc.reset_launch_counts()
    y = kops.conv1d_depthwise(base[..., 96:200], w, activation=activation)
    assert kc.conv1d_depthwise_cuda.launches == 1
    assert type(y.grad_fn).__name__ == "Conv1dDepthwiseBackward"
    gb, gw = torch.autograd.grad(y, (base, w), gy)
    assert kc.conv1d_depthwise_cuda.launches == 1  # the backward is plain
    want = ref.conv1d_depthwise(base[..., 96:200], w, activation)
    wb, ww = torch.autograd.grad(want, (base, w), gy)
    if activation == "none":
        assert torch.equal(y, want)
    else:  # an expf may differ by an ulp
        tol = 1e-5 if dtype == "float32" else 2e-2
        err = (y.detach().double() - want.detach().double()).abs().max()
        assert float(err) <= tol * float(want.detach().double().abs().max())
    assert torch.equal(gb, wb) and torch.equal(gw, ww)


@pytest.mark.cuda
def test_conv1d_function_refuses_what_the_kernel_refuses(cuda_device):
    """B7b's shapes (9 taps, float64) run the kernel under autograd too:
    one launch forward, equal to the plain version, the plain gradient
    backward. What the kernel still refuses (channels that are not
    adjacent) raises there as well: nothing drops to the plain forward on
    a CUDA tensor."""
    for dtype, k in ((torch.float32, 9), (torch.float64, 4),
                     (torch.float16, 16)):
        x = torch.randn((1, 16, 8), device=cuda_device).to(dtype)
        x.requires_grad_(True)
        w = torch.randn((k, 8), device=cuda_device).to(dtype)
        w.requires_grad_(True)
        kc.reset_launch_counts()
        y = kops.conv1d_depthwise(x, w)
        assert kc.conv1d_depthwise_cuda.launches == 1
        want = ref.conv1d_depthwise(x, w)
        assert torch.equal(y, want)
        gy = torch.randn_like(y)
        assert all(torch.equal(a, b) for a, b in zip(
            torch.autograd.grad(y, (x, w), gy),
            torch.autograd.grad(want, (x, w), gy)))
    xt = torch.randn((1, 8, 16), device=cuda_device).transpose(1, 2)
    xt.requires_grad_(True)
    with pytest.raises(ValueError, match="adjacent"):
        kops.conv1d_depthwise(xt, torch.randn((4, 8), device=cuda_device))


@pytest.mark.cuda
def test_serving_under_no_grad_keeps_the_bare_launch(cuda_device):
    base, w, _ = _xbc((2, 64, 40), 80, 8, torch.bfloat16, cuda_device)
    kc.reset_launch_counts()
    with torch.no_grad():
        y = kops.conv1d_depthwise(base[..., 8:48], w)
    assert y.grad_fn is None and kc.conv1d_depthwise_cuda.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ("none", "selective"))
def test_reduced_train_step_on_card_goes_through_b7(cuda_device, remat):
    """One layer's B7 launch a forward; selective remat launches each
    again in the backward's recompute. The loss equals the plain conv
    path's (which launches nothing) and the gradients lie within 1e-5
    of its (the same arithmetic; cuBLAS may pick other algorithms)."""
    cfg = dataclasses.replace(reduced_config(get_config("mamba2-780m")),
                              remat=remat)
    params = ssm.init_params(cfg, seed=0, device=cuda_device)
    nb = MarkovLMDataset(cfg.vocab, 64).batch(0, 0, 2)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in nb.items()}
    kc.reset_launch_counts()
    loss, _, grads = make_grad_step(cfg, device=cuda_device)(params, batch)
    torch.cuda.synchronize()
    per_layer = 2 if remat == "selective" else 1
    assert kc.conv1d_depthwise_cuda.launches == per_layer * cfg.n_layers
    kc.reset_launch_counts()
    want_loss, _, want = make_grad_step(
        cfg, device=cuda_device, use_pallas_conv=False)(params, batch)
    assert kc.conv1d_depthwise_cuda.launches == 0
    assert float(loss) == float(want_loss)
    for (path, g), (_, wg) in zip(tree_leaves_with_path(grads),
                                  tree_leaves_with_path(want)):
        assert bool(torch.isfinite(g).all()), path
        assert torch.allclose(g, wg, rtol=1e-5, atol=1e-7), path
    step = make_train_step(cfg, AdamWConfig(lr_peak=1e-3), device=cuda_device)
    new, opt, m = step(params, adamw_init(params), batch)
    assert int(opt.step) == 1 and np.isfinite(float(m["grad_norm"]))
    assert new["embed"].device == cuda_device
