"""LM serving entry point (port of ``repro.launch.serve``): batched decode
from a recurrent cache, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --reduced --batch 4 --steps 32 [--device cpu]

Decode-only, as the reference's; the parameters are a random init from
a seeded ``torch.Generator`` (the repository holds no trained weights),
and so are the first tokens and the sampling. Stencil simulation
workloads have their own entry point: ``python -m
repro_torch.launch.serve_sim``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_model, reduced_config
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.config import ModelConfig


def serve(cfg: ModelConfig, *, batch: int = 4, steps: int = 32,
          max_len: int = 128, temperature: float = 1.0, seed: int = 0,
          device: str | torch.device | None = None, params=None):
    """Decode ``steps`` tokens for ``batch`` sequences from an empty
    cache, sampling each from softmax(logits / temperature).

    Returns (tokens (batch, steps + 1) on the CPU, seconds): the first
    column is the random start token; the seconds run on the host clock
    from the first step to the last token, synchronised with the card.
    ``params`` defaults to ``init_params(cfg, seed)`` on ``device``.
    """
    dev = resolve_device(device)
    api = get_model(cfg)
    if params is None:
        params = api.init_params(cfg, seed, device=dev)
    cache = api.init_decode_cache(cfg, batch, max_len, device=dev)
    step = make_serve_step(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, 1), generator=gen,
                           device=dev)
    outs = [tokens]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(steps):
            logits, cache = step(params, cache, {"tokens": tokens})
            probs = torch.softmax(logits / temperature, dim=-1)
            tokens = torch.multinomial(probs, 1, generator=gen)
            outs.append(tokens)
        gen_tokens = torch.cat(outs, dim=1).cpu()
    return gen_tokens, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--auto-tune", action="store_true",
                    help="not ported: the tuner is ROADMAP A9")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the plain path")
    args = ap.parse_args(argv)

    if args.auto_tune:
        raise NotImplementedError(
            "--auto-tune is not ported yet: ROADMAP A9 (the tuner)"
        )
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.is_encdec:
        raise SystemExit(
            "repro_torch.launch.serve is decoder-only LM serving; stencil "
            "simulations are served by `python -m "
            "repro_torch.launch.serve_sim`"
        )
    gen, dt = serve(cfg, batch=args.batch, steps=args.steps,
                    max_len=args.max_len, temperature=args.temperature,
                    device=args.device)
    tps = args.batch * args.steps / dt
    print(f"generated {tuple(gen.shape)} tokens in {dt:.2f}s "
          f"({tps:.1f} tok/s)")
    for row in gen[: min(4, args.batch)].tolist():
        print("  ", " ".join(map(str, row[:24])), "...")


if __name__ == "__main__":
    main()
