#!/usr/bin/env python3
"""Where the transformer, hybrid and encoder-decoder families spend the
card's time, under ``torch.profiler``, as ``chip_smoke.py`` phases 3
(dense), 3 (moe), 3 (hybrid) and 3 (encdec) run them (random init from
seed 0 at full width): the prefill at (1, 8192) in bf16 and 8 decode
steps at batch 4 in bf16, each after a warm-up, of llama3-8b, or with
``--arch`` another arch of the registry (``--layers`` cuts its depth:
qwen3-moe-30b-a3b defaults to 16 of 48 layers, mixtral-8x7b to 4 of 32,
as phase 3 (moe) cuts them to fit one card; whisper-small's prefill is
its encoder on frames (4, 1500, 768) and its decoder on tokens (4, 448),
its decode steps run from ``init_decode_cache`` of that encoder
output); with ``--train``, one qwen2.5-3b train step at (1, 4096) bf16
with selective remat and donation on ``MarkovLMDataset`` batches, after
a warm-up step, and the step's two halves apart on the host clock
(gradient, AdamW). Prints kernel time by kernel, the largest first,
with its share of all kernel time, the device's busy share of the
host-clock window, and device time by ATen op, inclusive; and the device
time under each profiler range the model marks: ``models/moe.py``'s
(``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``:
the dispatch and combine einsums against the expert GEMMs) and
``models/hybrid.py``'s (``hybrid.conv``, ``hybrid.rg_lru``: the
temporal conv, the RG-LRU's gates and log-depth scan).

    PYTHONPATH=src python3 tools/profile_dense.py [--train]
    PYTHONPATH=src python3 tools/profile_dense.py --arch qwen3-moe-30b-a3b
    PYTHONPATH=src python3 tools/profile_dense.py --arch recurrentgemma-9b
    PYTHONPATH=src python3 tools/profile_dense.py --arch whisper-small

Needs one CUDA card.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

from profile_mamba2 import _report, _report_ops

PREFILL_SHAPE = (1, 8192)  # chip_smoke.py's DENSE_PREFILL
DECODE_BATCH, DECODE_STEPS = 4, 8
TRAIN_SHAPE = (1, 4096)  # chip_smoke.py's DENSE_TRAIN_SHAPE
# chip_smoke.py's MOE_QWEN_LAYERS and MOE_MIXTRAL_LAYERS
DEFAULT_LAYERS = {"qwen3-moe-30b-a3b": 16, "mixtral-8x7b": 4}
# chip_smoke.py's ENCDEC_BATCH: whisper-small's prefill and decode batch
ENCDEC_BATCH = 4
RANGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
          "hybrid.conv", "hybrid.rg_lru")


def _report_ranges(prof) -> None:
    """Device time under each of the models' profiler ranges, as the
    profiler reports each range: on the host's annotation, the kernels
    its ops launched; on the device's, its span on the device's
    timeline."""
    rows = [e for e in prof.key_averages() if e.key in RANGES]
    if not rows:
        return
    print("  by model range (device time, inclusive):")
    for e in sorted(rows, key=lambda e: (RANGES.index(e.key),
                                         str(e.device_type))):
        print(f"  {e.device_time_total / 1e3:9.3f} ms x{e.count:<6} "
              f"{e.key} ({e.device_type})")


def _option(name: str, default=None):
    argv = sys.argv[1:]
    return argv[argv.index(name) + 1] if name in argv else default


def train(dev, activities) -> None:
    import torch
    from torch.profiler import profile

    from repro_torch.configs.registry import get_config
    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.launch.steps import make_grad_step, make_train_step
    from repro_torch.models import transformer as tr
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    cfg = get_config("qwen2.5-3b")
    b, s = TRAIN_SHAPE
    opt_cfg = AdamWConfig(lr_peak=3e-4, warmup_steps=1, total_steps=4)
    params = tr.init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params)
    it = BatchIterator(MarkovLMDataset(cfg.vocab, s), b)
    batches = [it.next_global(dev) for _ in range(3)]
    step = make_train_step(cfg, opt_cfg, device=dev, donate=True)
    params, opt, _ = step(params, opt, batches[0])  # warm-up
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batches[1])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    _report(f"{cfg.arch_id} train step {TRAIN_SHAPE} {cfg.dtype} remat "
            f"{cfg.remat}", prof, wall)
    _report_ops(prof)
    del prof
    t0 = time.perf_counter()
    _, _, grads = make_grad_step(cfg, device=dev)(params, batches[2])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(opt_cfg, grads, opt, params, donate=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"  halves (host clock, no profiler): gradient "
          f"{1e3 * (t1 - t0):.1f} ms, adamw_update {1e3 * (t2 - t1):.1f} ms")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config, get_model
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    if not torch.cuda.is_available():
        print("profile_dense: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", torch.cuda.current_device())
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if "--train" in sys.argv[1:]:
        train(dev, activities)
        return 0
    arch = _option("--arch", "llama3-8b")
    cfg = get_config(arch)
    layers = int(_option("--layers", DEFAULT_LAYERS.get(arch, cfg.n_layers)))
    cfg = dataclasses.replace(cfg, n_layers=layers)
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    if cfg.is_encdec:
        from repro_torch.models import encdec

        shape = (ENCDEC_BATCH, cfg.max_target_len)
        frames = torch.randn((ENCDEC_BATCH, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=dev).to(torch.bfloat16)
        batch = {"frames": frames}
    else:
        shape, batch = PREFILL_SHAPE, {}
    batch["tokens"] = torch.randint(0, cfg.vocab, shape, generator=gen,
                                    device=dev)
    prefill = make_prefill_step(cfg, device=dev)
    step = make_serve_step(cfg, device=dev)
    with torch.no_grad():
        prefill(params, batch)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        _report(f"{cfg.arch_id} ({layers} layers) prefill {shape} "
                f"{cfg.dtype}", prof, wall, RANGES)
        _report_ops(prof)
        _report_ranges(prof)
        del prof
        if cfg.is_encdec:
            cache = encdec.init_decode_cache(
                params, cfg, encdec.encode(params, cfg, frames))
        else:
            cache = api.init_decode_cache(cfg, DECODE_BATCH,
                                          DECODE_STEPS + 1, device=dev)
        del batch
        tok = torch.zeros((DECODE_BATCH, 1), dtype=torch.long, device=dev)
        _, cache = step(params, cache, {"tokens": tok})  # warm-up
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(DECODE_STEPS):
                _, cache = step(params, cache, {"tokens": tok})
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        _report(f"{cfg.arch_id} ({layers} layers) decode, {DECODE_STEPS} "
                f"steps at batch {DECODE_BATCH} {cfg.dtype}", prof, wall,
                RANGES)
        _report_ops(prof)
        _report_ranges(prof)
    return 0


if __name__ == "__main__":
    sys.exit(main())
