#!/usr/bin/env python3
"""How far two correct mamba2 computations drift apart with depth, on the
CPU, at a narrow width (d_model 256; full depth 48, the
published state 128, head dim 64 and chunk 256).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/mamba2_drift.py decode
    PYTHONPATH=src python tools/mamba2_drift.py rounding

``decode``: the largest |decode_step logits - forward logits| over a
(2, 512) prompt in float32, for the port and for the JAX reference, at
48 and 4 layers and chunks 256 and 16 (the reference's
``tests/test_system.py:67`` check, which holds 5e-4 at its reduced
config). ``rounding``: the port's bfloat16 last-position logits with the
conv rounded once (float32 sum) against the plain conv's per-op
rounding, and the bf16 forward against the f32 forward, at 4, 12 and 48
layers: how strongly a random-init model amplifies a change of rounding.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

WIDTH = 256


def _cfg(registry, layers, width, chunk, dtype):
    return dataclasses.replace(
        registry.get_config("mamba2-780m"), n_layers=layers, d_model=width,
        vocab=4096, ssm_chunk=chunk, dtype=dtype, remat="none",
    )


def decode(width: int, seq: int) -> None:
    import torch

    from repro_torch.configs import registry as treg
    from repro_torch.models import ssm as tssm

    for layers, chunk in ((48, 256), (48, 16), (4, 256)):
        cfg = _cfg(treg, layers, width, chunk, "float32")
        params = tssm.init_params(cfg, seed=0, device="cpu")
        tok = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab, (2, seq)))
        with torch.no_grad():
            full, _ = tssm.forward(params, cfg, tok)
            cache = tssm.init_decode_cache(cfg, 2, seq, device="cpu")
            worst = 0.0
            for t in range(seq):
                lg, cache = tssm.decode_step(params, cfg, tok[:, t:t + 1],
                                             cache)
                worst = max(worst, float((lg - full[:, t]).abs().max()))
        print(f"port L={layers} d={width} chunk={chunk} s={seq}: max|err| "
              f"{worst:.3e}, largest |logit| {float(full.abs().max()):.3f}",
              flush=True)
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.models import ssm as jssm

    for layers, chunk in ((48, 256), (48, 16), (4, 256)):
        cfg = _cfg(jreg, layers, width, chunk, "float32")
        params = jssm.init_params(cfg, jax.random.PRNGKey(0))
        tok = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab,
                                                            (2, seq)))
        full, _ = jax.jit(lambda p, t, c=cfg: jssm.forward(p, c, t))(params,
                                                                     tok)
        step = jax.jit(lambda p, t, k, c=cfg: jssm.decode_step(p, c, t, k))
        cache = jssm.init_decode_cache(cfg, 2, seq)
        worst = 0.0
        for t in range(seq):
            lg, cache = step(params, tok[:, t:t + 1], cache)
            worst = max(worst, float(jnp.abs(lg - full[:, t]).max()))
        print(f"JAX  L={layers} d={width} chunk={chunk} s={seq}: max|err| "
              f"{worst:.3e}, largest |logit| {float(jnp.abs(full).max()):.3f}",
              flush=True)


def rounding(width: int, seq: int) -> None:
    import torch

    from repro_torch.configs import registry as treg
    from repro_torch.kernels import ops as kops
    from repro_torch.models import ssm as tssm

    def round_once(x, w, *, activation="none", block_seq=512):
        k = w.shape[0]
        xp = torch.nn.functional.pad(x.float(), (0, 0, k - 1, 0))
        acc = sum(w[j].float() * xp[:, j:j + x.shape[1]] for j in range(k))
        return acc.to(x.dtype)

    kops.conv1d_depthwise_cuda = round_once  # stands in for a round-once B7
    for layers in (4, 12, 48):
        cfg = dataclasses.replace(_cfg(treg, layers, width, 64, "bfloat16"),
                                  ssm_state=64, ssm_head_dim=32)
        params = tssm.init_params(cfg, seed=0, device="cpu")
        tok = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab, (2, seq)))
        with torch.no_grad():
            once, _ = tssm.forward(params, cfg, tok, use_pallas_conv=True)
            plain, _ = tssm.forward(params, cfg, tok, use_pallas_conv=False)
            f32, _ = tssm.forward(
                params, dataclasses.replace(cfg, dtype="float32"), tok)
        last = plain[:, -1].float()

        def rel(a):
            return float((a - last).abs().max() / last.abs().max())

        print(f"L={layers} d={width}: bf16 last logits, conv rounded once "
              f"vs per op {rel(once[:, -1].float()):.3e}; bf16 vs f32 "
              f"(rel to bf16) {rel(f32[:, -1]):.3e}", flush=True)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("decode", "rounding"))
    args = ap.parse_args(argv)
    if args.what == "decode":
        decode(WIDTH, 512)
    else:
        rounding(WIDTH, 256)


if __name__ == "__main__":
    sys.exit(main())
