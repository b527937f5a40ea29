"""End-to-end training on the PyTorch/CUDA port, the counterpart of
``examples/train_lm.py`` (and of ``repro_torch.launch.train``'s loop): a
~15M-parameter transformer trained on learnable Markov-chain data, with
checkpointing, an injected node failure, automatic restore and
bit-identical data replay — the whole fault-tolerance path.

Run:  PYTHONPATH=src python examples/torch_train_lm.py          (the card)
      PYTHONPATH=src python examples/torch_train_lm.py --steps 100 --device cpu
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, get_model
from repro_torch.data import BatchIterator, MarkovLMDataset
from repro_torch.ft import Supervisor
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import AdamWConfig, adamw_init


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--fail-at", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ~15M params: a shrunken qwen2.5 (same family/topology).
    cfg = dataclasses.replace(
        get_config("qwen2.5-3b"),
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=1024, vocab=512, dtype="float32", remat="none",
    )
    print(f"model: {cfg.n_params()/1e6:.1f}M params on {device}")

    dataset = MarkovLMDataset(vocab=cfg.vocab, seq_len=args.seq_len,
                              branching=4)
    print(f"data: order-1 Markov chain, entropy rate "
          f"{dataset.entropy_rate:.3f} nats/token")

    opt_cfg = AdamWConfig(lr_peak=8e-3, warmup_steps=20,
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, device=device)
    api = get_model(cfg)

    def fresh():
        params = api.init_params(cfg, seed=0, device=device)
        return {"params": params, "opt": adamw_init(params)}

    with tempfile.TemporaryDirectory(prefix="repro_torch_train_lm_") as d:
        ckpt = CheckpointManager(d, keep=2)
        sup = Supervisor(ckpt, ckpt_every=50)
        losses = []

        def one_step(state, step):
            it = BatchIterator(dataset, args.global_batch, host_index=0,
                               host_count=1, start_step=step)
            params, opt, metrics = step_fn(
                state["params"], state["opt"], it.next_global(device)
            )
            loss = float(metrics["loss"])
            losses.append((step, loss))
            if step % 25 == 0:
                print(f"  step {step:4d}  loss {loss:.4f}", flush=True)
            return {"params": params, "opt": opt}

        def restore(state, step):
            if step is None:  # no checkpoint yet: replay from the seed
                return fresh(), 0
            restored, got = ckpt.restore(state, step)
            print(f"  >> restored checkpoint at step {got}")
            return restored, got

        t0 = time.time()
        state, report = sup.run(
            fresh(), one_step, args.steps,
            failure_at=args.fail_at, restore_fn=restore,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0

    first = losses[0][1]
    final = losses[-1][1]
    print(
        f"\ntrained {args.steps} steps in {dt:.1f}s "
        f"({args.steps*args.global_batch*args.seq_len/dt:.0f} tok/s): "
        f"loss {first:.3f} → {final:.3f} "
        f"(entropy rate {dataset.entropy_rate:.3f}); "
        f"injected failures recovered: {report['restarts']}"
    )
    assert final < first - 0.5, "loss should drop by >0.5 nats"
    assert report["restarts"] == 1, "expected exactly one injected failure"
    print("train_lm OK")


if __name__ == "__main__":
    main()
