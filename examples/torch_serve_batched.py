"""Batched serving with continuous-batching-lite on the PyTorch/CUDA
port, the counterpart of ``examples/serve_batched.py``: a fixed device
batch of decode slots; finished sequences are immediately replaced from
a request queue, so the slots stay busy as requests of different
lengths complete — the core scheduling idea behind production LLM
serving, on a reduced model.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_model, reduced_config
from repro_torch.launch.serve_sim import RequestQueue
from repro_torch.launch.steps import make_serve_step


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced_config(get_config(args.arch))
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device=device)

    rng = np.random.default_rng(0)
    # Request queue (shared scaffolding with the ensemble serving loop):
    # (id, prompt token, target length) — lengths differ so slots free
    # at different times.
    queue = RequestQueue(
        (i, int(rng.integers(0, cfg.vocab)),
         int(rng.integers(args.max_new // 3, args.max_new)))
        for i in range(args.requests)
    )
    # The cache holds every step of the run: at most the queue's tokens
    # over the slots, plus the longest request.
    max_len = -(-args.requests * args.max_new // args.slots) + args.max_new
    cache = api.init_decode_cache(cfg, args.slots, max_len, device=device)
    serve = make_serve_step(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def step(cache, tokens):
        with torch.no_grad():
            logits, cache = serve(params, cache, {"tokens": tokens})
        nxt = torch.multinomial(torch.softmax(logits, -1), 1, generator=gen)
        return cache, nxt

    slot_req = [-1] * args.slots  # request id per slot
    slot_left = [0] * args.slots  # tokens remaining
    outputs: dict[int, list[int]] = {}
    tokens = torch.zeros((args.slots, 1), dtype=torch.int64, device=device)
    completed, t0, steps = 0, time.time(), 0

    def fill_slots():
        nonlocal tokens
        tok_host = tokens.cpu()
        for s in range(args.slots):
            if slot_left[s] == 0 and queue:
                rid, prompt, length = queue.pop()
                slot_req[s], slot_left[s] = rid, length
                outputs[rid] = []
                tok_host[s, 0] = prompt
        tokens = tok_host.to(device)

    fill_slots()
    while completed < args.requests:
        cache, tokens = step(cache, tokens)
        steps += 1
        tok_host = tokens.cpu()
        for s in range(args.slots):
            if slot_left[s] > 0:
                outputs[slot_req[s]].append(int(tok_host[s, 0]))
                slot_left[s] -= 1
                if slot_left[s] == 0:
                    completed += 1
        fill_slots()

    dt = time.time() - t0
    total_tokens = sum(len(v) for v in outputs.values())
    print(
        f"served {args.requests} requests / {total_tokens} tokens in "
        f"{steps} batch-steps, {dt:.2f}s "
        f"({total_tokens/dt:.1f} tok/s, slot util "
        f"{total_tokens/(steps*args.slots)*100:.0f}%) on {device}"
    )
    for rid in sorted(outputs)[:4]:
        print(f"  req {rid}: {len(outputs[rid])} tokens: "
              f"{outputs[rid][:10]}...")
    assert completed == args.requests
    print("serve_batched OK")


if __name__ == "__main__":
    main()
