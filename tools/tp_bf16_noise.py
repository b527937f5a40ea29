#!/usr/bin/env python3
"""How far two correct one-rank bf16 runs of llama3-8b lie apart, beside
which ``chip_smoke.py`` phase 3 (tp) reads its tensor-parallel bf16
errors (random init from seed 0 at full width, the phase's tokens).

The second run differs from the first only in the order in which
``w_down``'s product sums in float32 (two halves of d_ff added, as a
row-parallel product over two ranks adds them), then rounds to bf16
once. Prints, as fractions of the first run's max |logit|: the
prefill's last logits at (1, 8192) (a repeat of the first run, the
split run, and the first run against the f32 prefill); the bf16 serve
step at batch 4, 32 teacher-forced steps from an empty cache, the worst
step by its own max |logit| and over all steps.

    PYTHONPATH=src python3 tools/tp_bf16_noise.py

Needs one CUDA card.
"""
from __future__ import annotations

import dataclasses
import sys

PREFILL_SHAPE = (1, 8192)  # chip_smoke.py's TP_PREFILL
DECODE = (4, 32)  # batch, steps (chip_smoke.py's TP_DECODE cuts them to 8)


def main() -> int:
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tr

    if not torch.cuda.is_available():
        print("tp_bf16_noise: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("llama3-8b")
    params = tr.init_params(cfg, seed=0, device=dev)

    def tokens(shape, seed):  # chip_smoke.py's _tp_tokens
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)

    def prefill(c):
        with torch.no_grad():
            return make_prefill_step(c, device=dev)(
                params, {"tokens": tokens(PREFILL_SHAPE, 1)})

    def decode():
        b, steps = DECODE
        cache = tr.init_decode_cache(cfg, b, steps, device=dev)
        step, toks, out = make_serve_step(cfg, device=dev), tokens(DECODE, 2), []
        with torch.no_grad():
            for t in range(steps):
                lg, cache = step(params, cache, {"tokens": toks[:, t:t + 1]})
                out.append(lg)
        return torch.stack(out)

    def split(x, w_gate, w_up, w_down, kind="swiglu"):
        h = L.gated_hidden(x, w_gate, w_up, kind)
        k = h.shape[-1] // 2
        return (h[..., :k].float() @ w_down[:k].float()
                + h[..., k:].float() @ w_down[k:].float()).to(x.dtype)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    plain = L.gated_mlp
    want, again, want_dec = prefill(cfg), prefill(cfg), decode()
    L.gated_mlp = split
    try:
        got, got_dec = prefill(cfg), decode()
    finally:
        L.gated_mlp = plain
    f32 = prefill(dataclasses.replace(cfg, dtype="float32"))
    name = torch.cuda.get_device_name(0)
    print(f"{cfg.arch_id} bf16 on {name}: prefill {PREFILL_SHAPE} last "
          f"logits, a repeat {rel(again, want):.3e}, w_down summed in two "
          f"f32 halves {rel(got, want):.3e}, the bf16 prefill against the f32 one "
          f"{rel(want, f32):.3e}; decode {DECODE}, w_down in two halves: "
          f"worst step {max(rel(got_dec[t], want_dec[t]) for t in range(len(want_dec))):.3e}, "
          f"over all steps {rel(got_dec, want_dec):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
