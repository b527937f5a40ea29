"""Training entry point (port of ``repro.launch.train``): mamba2 on one card,
fault-tolerant.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --steps 50 --global-batch 8 --seq-len 64 [--device cpu]

    # fault injection + restart (the ft path exercised end to end):
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --steps 60 --simulate-failure-at 25

The loop is the reference's: ``MarkovLMDataset`` batches by step number
(``BatchIterator``), ``make_train_step`` (``lm_loss``'s gradient, with
the B7 kernel on the card, then AdamW), ``Supervisor`` checkpointing
every ``--ckpt-every`` steps through ``CheckpointManager`` and replaying
from the last checkpoint after a failure. Only ``--mesh 1x1`` runs: the
data-parallel mesh is the next slice of ROADMAP A13.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, get_model, reduced_config
from repro_torch.data import BatchIterator, MarkovLMDataset
from repro_torch.ft import Supervisor
from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import AdamWConfig, adamw_init


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--reduced", action="store_true",
                    help="toy-size config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--auto-tune", action="store_true",
                    help="resolve the conv kernel's block through the "
                         "tuner (repro_torch.tuning), pre-measuring this "
                         "run's shape before the first step")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the plain path")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh} is not ported yet: ROADMAP A13's next "
            "slice (data-parallel training: distrib/grad_sync.py, "
            "distrib/sharding.py, make_production_mesh, --mesh)"
        )
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.auto_tune:
        from repro_torch import tuning

        tuning.enable_auto()
        warmed = tuning.warm_model_kernels(
            cfg, args.global_batch, args.seq_len, device=dev
        )
        print(f"auto-tune: {warmed} kernel shape(s) warmed; cache at "
              f"{tuning.default_cache_dir()}")

    api = get_model(cfg)
    opt_cfg = AdamWConfig(
        lr_peak=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
    )
    dataset = MarkovLMDataset(
        vocab=cfg.vocab, seq_len=args.seq_len, branching=4
    )
    print(f"dataset entropy rate: {dataset.entropy_rate:.3f} nats/token")
    step_fn = make_train_step(cfg, opt_cfg, device=dev)

    params = api.init_params(cfg, seed=0, device=dev)
    opt_state = adamw_init(params)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    sup = Supervisor(ckpt, ckpt_every=args.ckpt_every)

    state = {"params": params, "opt": opt_state}
    losses: list[float] = []

    def one_step(state, step):
        it = BatchIterator(
            dataset, args.global_batch, host_index=0, host_count=1,
            start_step=step,
        )
        params, opt, metrics = step_fn(state["params"], state["opt"],
                                       it.next_global(dev))
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"step {step:5d}  loss {loss:.4f}  "
                f"lr {float(metrics['lr']):.2e}  "
                f"gnorm {float(metrics['grad_norm']):.3f}",
                flush=True,
            )
        return {"params": params, "opt": opt}

    def restore(state, step):
        if step is None:  # no checkpoint yet: replay from the seeded init
            params = api.init_params(cfg, seed=0, device=dev)
            return {"params": params, "opt": adamw_init(params)}, 0
        return ckpt.restore(state, step)

    kc.reset_launch_counts()
    t0 = time.time()
    state, report = sup.run(
        state, one_step, args.steps,
        failure_at=args.simulate_failure_at,
        restore_fn=restore,
        save_filter=lambda s: s,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(
        f"\ndone: {args.steps} steps in {dt:.1f}s  "
        f"final loss {losses[-1]:.4f}  (entropy rate "
        f"{dataset.entropy_rate:.3f})  restarts={report['restarts']} "
        f"stragglers={report['stragglers']}  device={dev}  "
        f"conv1d_depthwise launches={kc.conv1d_depthwise_cuda.launches}"
    )


if __name__ == "__main__":
    main()
