"""Training entry point (port of ``repro.launch.train``): a language
model of the registry (mamba2-780m by default; the dense, MoE and
hybrid transformers and the VLM with ``--arch``) on one card or data-
and tensor-parallel over a mesh of ranks, fault-tolerant. The
encoder-decoder (whisper-small) exits with the reference's
``SystemExit``.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --steps 50 --global-batch 8 --seq-len 64 [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --steps 50 --global-batch 8 --seq-len 64 --device cpu

    # fault injection + restart (the ft path exercised end to end):
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --steps 60 --simulate-failure-at 25

    # data-parallel over two CPU ranks (gloo):
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --backend gloo --mesh 2x1

    # tensor-parallel (the tp profile's model axis) over two CPU ranks,
    # and tensor x data parallel over four (any arch but whisper-small):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --device cpu --backend gloo --mesh 1x2
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --backend gloo --mesh 2x2

The loop is the reference's: ``MarkovLMDataset`` batches by step number
(``BatchIterator``), ``make_train_step`` (``lm_loss``'s gradient, for
mamba2 with the B7 kernel on the card, then AdamW), ``Supervisor``
checkpointing every ``--ckpt-every`` steps through ``CheckpointManager``
and replaying from the last checkpoint after a failure.

``--mesh DxM`` / ``PxDxM`` (``launch.mesh.parse_mesh``) above one rank
starts one process per rank (``launch.mesh.run_on_mesh``) over
``--backend`` ``nccl`` (the default: one card per rank; it raises with
fewer cards) or ``gloo`` (CPU ranks with ``--device cpu``, or several
ranks sharing a card: correctness and costs, never a scaling figure).
The step runs the reference's ``tp`` profile: each rank takes its rows
of every global batch (the batch over ``(pod, data)``), and a ``model``
axis above 1 cuts what the reference's rules cut over its ranks
(tensor parallelism; each rank keeps its blocks of the seeded
parameters): the dense, MoE and VLM archs' heads, FFN hidden and vocab,
mamba2's ``in_proj`` columns, conv taps and heads, the hybrid's
embeddings; the ranks join the gradient sum over ``(pod, data)``.
Checkpoints hold whole leaves. Rank 0 prints.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, get_model, reduced_config
from repro_torch.data import BatchIterator, MarkovLMDataset
from repro_torch.distrib import sharding as shlib
from repro_torch.ft import StragglerMonitor, Supervisor
from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.launch.mesh import parse_mesh, run_on_mesh
from repro_torch.launch.steps import make_train_step, train_shardings
from repro_torch.optim import AdamWConfig, adamw_init


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--reduced", action="store_true",
                    help="toy-size config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM ranks (data, model; pod outermost)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="process-group backend of a mesh above one rank")
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
    return ap


def _config(args):
    cfg = get_config(args.arch)
    return reduced_config(cfg) if args.reduced else cfg


def main(argv: list[str] | None = None) -> None:
    args = _parser().parse_args(argv)
    shape, axes = parse_mesh(args.mesh)
    world = math.prod(shape)
    cfg = _config(args)
    if cfg.is_encdec:
        raise SystemExit(
            "repro_torch.launch.train trains decoder-only language models; "
            "an encoder-decoder's batch carries frames: train it through "
            "repro_torch.launch.steps.make_train_step"
        )
    if world == 1:
        _train(None, vars(args))
        return
    if args.backend == "nccl":
        cards = torch.cuda.device_count()
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        if cpu or cards < world:
            raise RuntimeError(
                f"--backend nccl needs one card per rank: --mesh {args.mesh} "
                f"has {world} ranks and there are "
                f"{0 if cpu else cards} cards for them; use --backend gloo "
                "(CPU ranks with --device cpu, or ranks sharing a card)"
            )
    # By the module's import name, which a spawned rank can load even
    # when this file runs as ``__main__``.
    from repro_torch.launch import train as this

    run_on_mesh(this._train, shape, axes, backend=args.backend,
                device=args.device, args=(vars(args),), timeout=24 * 3600)


def _train(mesh, opts: dict) -> None:
    """The training loop on one rank of ``mesh`` (None: one process)."""
    args = argparse.Namespace(**opts)
    rank = 0 if mesh is None else torch.distributed.get_rank()
    dev = (resolve_device(args.device) if mesh is None else
           torch.device("cpu") if args.device == "cpu" else
           torch.device("cuda", torch.cuda.current_device()))

    def say(*a, **kw):
        if rank == 0:
            print(*a, **kw, flush=True)

    cfg = _config(args)
    if args.auto_tune:
        from repro_torch import tuning

        tuning.enable_auto()
        warmed = tuning.warm_model_kernels(
            cfg, args.global_batch, args.seq_len, device=dev
        )
        say(f"auto-tune: {warmed} kernel shape(s) warmed; cache at "
            f"{tuning.default_cache_dir()}")

    api = get_model(cfg)
    opt_cfg = AdamWConfig(
        lr_peak=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
    )
    dataset = MarkovLMDataset(
        vocab=cfg.vocab, seq_len=args.seq_len, branching=4
    )
    say(f"dataset entropy rate: {dataset.entropy_rate:.3f} nats/token")
    if mesh is None:
        step_fn = make_train_step(cfg, opt_cfg, device=dev)
        shardings, p_sh, host, hosts = None, None, 0, 1
    else:
        step_fn = make_train_step(cfg, opt_cfg, device=dev, mesh=mesh)
        p_sh, o_sh = train_shardings(cfg, mesh)
        shardings = {"params": p_sh, "opt": o_sh}
        host = shlib.axis_index(mesh, shlib.dp_axes())
        hosts = shlib.axes_size(mesh, shlib.dp_axes())
        say(f"mesh {shlib.mesh_axis_sizes(mesh)}: {hosts} data-parallel "
            f"ranks, {args.global_batch // hosts} rows each")

    def fresh():
        params = api.init_params(cfg, seed=0, device=dev)
        if p_sh is not None:  # this rank's blocks of the seeded tree
            params = shlib.shard_tree(params, p_sh)
        return {"params": params, "opt": adamw_init(params)}

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    sup = Supervisor(ckpt, ckpt_every=args.ckpt_every,
                     straggler=StragglerMonitor(rank=rank),
                     shardings=shardings)
    losses: list[float] = []

    def one_step(state, step):
        it = BatchIterator(
            dataset, args.global_batch, host_index=host, host_count=hosts,
            start_step=step,
        )
        params, opt, metrics = step_fn(state["params"], state["opt"],
                                       it.next_global(dev))
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(
                f"step {step:5d}  loss {loss:.4f}  "
                f"lr {float(metrics['lr']):.2e}  "
                f"gnorm {float(metrics['grad_norm']):.3f}",
            )
        return {"params": params, "opt": opt}

    def restore(state, step):
        if step is None:  # no checkpoint yet: replay from the seeded init
            return fresh(), 0
        return ckpt.restore(state, step, shardings=shardings)

    kc.reset_launch_counts()
    t0 = time.time()
    state, report = sup.run(
        fresh(), one_step, args.steps,
        failure_at=args.simulate_failure_at,
        restore_fn=restore,
        save_filter=lambda s: s,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    final = f"{losses[-1]:.4f}" if losses else "n/a"
    conv = (f"  conv1d_depthwise launches="
            f"{kc.conv1d_depthwise_cuda.launches}" if cfg.family == "ssm"
            else "")
    say(
        f"\ndone: {args.steps} steps in {dt:.1f}s  "
        f"final loss {final}  (entropy rate "
        f"{dataset.entropy_rate:.3f})  restarts={report['restarts']} "
        f"stragglers={report['stragglers']}  device={dev}  "
        f"mesh={args.mesh}  arch={cfg.arch_id}{conv}"
    )


if __name__ == "__main__":
    main()
