"""The dense transformer family on the card: the reduced qwen2.5-3b and
qwen2-vl-7b's ``forward`` logits and ``lm_loss`` gradients against the
same parameters on the CPU, and no kernel of B1-B7 launched (the
family runs in plain PyTorch, as the reference computes it outside any
Pallas kernel).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports nothing of JAX, so it runs on a machine with the
card and PyTorch alone (``tests/test_torch_transformer.py`` and
``tests/test_torch_dense_train.py`` hold the port to the JAX package on
the CPU).

Tolerance: relative L2 within 1e-4 in float32 with TF32 off (the same
sums in other orders).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.kernels import emit
from repro_torch.kernels import xcorr1d as kx
from repro_torch.launch.steps import make_grad_step
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_leaves_with_path, tree_map

TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _batch(cfg, b=2, s=64):
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    if cfg.family == "vlm":
        t = torch.arange(s).expand(b, s)
        batch["positions"] = torch.stack([t, t // 8, t % 8])
        batch["patch_embeds"] = torch.randn((b, cfg.n_patches, cfg.d_model),
                                            generator=gen)
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("qwen2.5-3b", "qwen2-vl-7b"))
def test_forward_and_gradients_on_card_match_the_cpu(cuda_device, arch):
    cfg = reduced_config(get_config(arch))
    params = tr.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg)
    on_card = tree_map(lambda v: v.to(cuda_device), params)
    batch_card = {k: v.to(cuda_device) for k, v in batch.items()}
    extra = [k for k in ("positions", "patch_embeds") if k in batch]
    kc.reset_launch_counts()
    emit.reset_launch_counts()
    kx.reset_launch_counts()
    with torch.no_grad():
        want, _ = tr.forward(params, cfg, batch["tokens"],
                             **{k: batch[k] for k in extra})
        got, _ = tr.forward(on_card, cfg, batch_card["tokens"],
                            **{k: batch_card[k] for k in extra})
    assert _rel_l2(got, want) <= TOL
    loss_c, _, grads_c = make_grad_step(cfg, device="cpu")(params, batch)
    loss_g, _, grads_g = make_grad_step(cfg, device=cuda_device)(on_card,
                                                                 batch_card)
    assert abs(float(loss_g) - float(loss_c)) <= TOL * float(loss_c)
    for (path, g), (_, w) in zip(tree_leaves_with_path(grads_g),
                                 tree_leaves_with_path(grads_c)):
        assert _rel_l2(g, w) <= TOL, path
    assert (kc.conv1d_depthwise_cuda.launches, emit.fused_stencil_swc.launches,
            kx.xcorr1d_cuda.launches) == (0, 0, 0)


@pytest.mark.cuda
def test_decode_on_card_matches_forward(cuda_device):
    """Decode from an empty cache against the forward on the card, f32,
    within the reference's 5e-4 (``tests/test_system.py:85``), through a
    ring of 8 slots."""
    cfg = reduced_config(get_config("llama3-8b"))
    params = tr.init_params(cfg, seed=1, device=cuda_device)
    tokens = _batch(cfg, s=12)["tokens"].to(cuda_device)
    with torch.no_grad():
        for c in (cfg, dataclasses.replace(cfg, sliding_window=8)):
            full, _ = tr.forward(params, c, tokens)
            cache = tr.init_decode_cache(c, 2, 16, device=cuda_device)
            for t in range(12):
                lg, cache = tr.decode_step(params, c, tokens[:, t:t + 1],
                                           cache)
                assert float((lg - full[:, t]).abs().max()) < 5e-4
