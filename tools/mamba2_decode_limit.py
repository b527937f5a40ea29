#!/usr/bin/env python3
"""Readings for the limit of ``chip_smoke.py``'s full-width decode check.

mamba2-780m at full width (48 layers, d_model 1536, chunk 256, random
init), float32, TF32 off, on a (2, 512) prompt: the largest
|decode_step logits - forward logits| over all 512 steps from an empty
cache, as ``chip_smoke.py`` phase 3 (mamba2) reads it. Sound readings
come from four seeds of the weights and tokens. The fault readings come
from seed 0 with one fault planted in the decode path for the run (the
repository's code is not changed):

- ``conv window frozen``: the carried conv inputs are never shifted on,
  so every step convolves the current input with zeros;
- ``state decays twice``: each step applies the state's decay
  ``exp(dt·A)`` twice, one step too many;
- ``state in bf16``: the SSM state is rounded to bfloat16 between steps.

    PYTHONPATH=src python3 tools/mamba2_decode_limit.py

Needs one CUDA card; builds B7 at first use.
"""
from __future__ import annotations

import contextlib
import subprocess
import sys

import torch

SEEDS = (0, 1, 2, 3)
DECODE_SHAPE = (2, 512)  # chip_smoke.py's: two SSD chunks of 256


class _DecayTwice:
    """``torch`` as ``ssm.decode_step`` sees it, with the (b, h) decay
    ``exp(dt·A)`` squared; every other name is torch's own."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def exp(x):
        e = torch.exp(x)
        return e * e if x.dim() == 2 else e


@contextlib.contextmanager
def _shadow_torch(ssm, stand_in):
    saved = ssm.torch
    ssm.torch = stand_in
    try:
        yield
    finally:
        ssm.torch = saved


def _worst(ssm, params, cfg, toks, step, fault_ctx) -> tuple[float, float]:
    """(max |decode - forward| over every step, largest |logit|)."""
    full, _ = ssm.forward(params, cfg, toks)
    cache = ssm.init_decode_cache(cfg, toks.shape[0], toks.shape[1],
                                  device=toks.device)
    errs = torch.empty(toks.shape[1], device=toks.device)
    with fault_ctx():
        for t in range(toks.shape[1]):
            lg, cache = step(params, cfg, toks[:, t:t + 1], cache)
            errs[t] = (lg.float() - full[:, t]).abs().max()
    return float(errs.max()), float(full.abs().max())


def main() -> int:
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import ssm

    if not torch.cuda.is_available():
        print("mamba2_decode_limit: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config("mamba2-780m")
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def frozen_conv(params, c, tok, cache):
        lg, new = ssm.decode_step(params, c, tok, cache)
        return lg, ssm.SSMCache(cache.conv, new.state, new.length)

    def bf16_state(params, c, tok, cache):
        lg, new = ssm.decode_step(params, c, tok, cache)
        state = new.state.to(torch.bfloat16).float()
        return lg, ssm.SSMCache(new.conv, state, new.length)

    faults = (
        ("conv window frozen", frozen_conv, contextlib.nullcontext),
        ("state decays twice", ssm.decode_step,
         lambda: _shadow_torch(ssm, _DecayTwice())),
        ("state in bf16", bf16_state, contextlib.nullcontext),
    )
    sound = []
    with torch.no_grad():
        for seed in SEEDS:
            params = ssm.init_params(cfg, seed=seed, device=dev)
            gen = torch.Generator(device=dev).manual_seed(seed + 1)
            toks = torch.randint(0, cfg.vocab, DECODE_SHAPE, generator=gen,
                                 device=dev)
            worst, peak = _worst(ssm, params, cfg32, toks, ssm.decode_step,
                                 contextlib.nullcontext)
            sound.append(worst)
            print(f"sound, seed {seed}: max|err| {worst:.3e} (largest "
                  f"|logit| {peak:.3f})", flush=True)
            if seed == SEEDS[0]:
                for name, step, ctx in faults:
                    bad, _ = _worst(ssm, params, cfg32, toks, step, ctx)
                    print(f"fault '{name}', seed {seed}: max|err| "
                          f"{bad:.3e}", flush=True)
            del params, toks
            torch.cuda.empty_cache()
    print(f"largest sound reading {max(sound):.3e} over seeds {SEEDS} "
          f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
