#!/usr/bin/env python3
"""Where mamba2-780m spends the card's time, under ``torch.profiler``:
one prefill at (4, 8192) in bf16 at full width (random init from seed
0, as ``chip_smoke.py`` runs it), and 8 decode steps at batch 4, each
after a warm-up; with ``--train``, one train step at (2, 4096) bf16 with
selective remat on ``MarkovLMDataset`` batches (``chip_smoke.py`` phase
3 (train)'s), after a warm-up step, and the step's two halves apart on
the host clock (gradient, AdamW). Prints kernel time by kernel, the
largest first, with its share of all kernel time, the device's busy
share of the host-clock window, B7's (``conv1d_depthwise_kernel``)
share, and (train) device time by ATen op, inclusive.

    PYTHONPATH=src python3 tools/profile_mamba2.py [--train]

Needs one CUDA card; builds the kernels at first use.
"""
from __future__ import annotations

import subprocess
import sys
import time

# CUPTI's record that the launch queue was full (the host waiting on the
# device), not a kernel.
NOT_KERNELS = ("Command Buffer Full",)
PREFILL_SHAPE = (4, 8192)  # chip_smoke.py's
DECODE_BATCH, DECODE_STEPS = 4, 8
TRAIN_SHAPE = (2, 4096)  # chip_smoke.py's phase 3 (train)
TOP = 20  # kernels listed per window


def _report(title: str, prof, wall_ms: float, ranges=()) -> None:
    """Kernel time by kernel; ``ranges`` names ``record_function``
    ranges, whose device-side spans are not kernels."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.key not in NOT_KERNELS and e.key not in ranges
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in kernels) / 1e3  # ms
    print(f"{title}: {wall_ms:.1f} ms host clock under the profiler, "
          f"{total:.1f} ms in {sum(e.count for e in kernels)} kernel "
          f"launches of {len(kernels)} kernels; device busy "
          f"{total / wall_ms:.1%} of the window")
    for e in kernels[:TOP]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.3f} ms {ms / max(total, 1e-9):6.1%} x{e.count:<5} "
              f"{e.key[:100]}")
    b7 = sum(e.self_device_time_total for e in kernels
             if "conv1d_depthwise_kernel" in e.key) / 1e3
    print(f"  B7 conv1d_depthwise_kernel: {b7:.3f} ms, "
          f"{b7 / max(total, 1e-9):.2%} of kernel time")
    if total > wall_ms:
        raise RuntimeError(
            f"{title}: {total:.1f} ms of kernel time in a {wall_ms:.1f} ms "
            "window: kernel time is over-counted")


def _report_ops(prof, n: int = TOP) -> None:
    """ATen ops by device time, inclusive of the ops they call (so
    nested ops count twice: a reading, not a sum)."""
    ops = [e for e in prof.key_averages()
           if e.key.startswith("aten::") and e.device_time_total > 0]
    ops.sort(key=lambda e: e.device_time_total, reverse=True)
    print("  by ATen op (device time, inclusive):")
    for e in ops[:n]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms x{e.count:<6} {e.key}")


def train(dev, cfg, activities) -> None:
    import torch
    from torch.profiler import profile

    from repro_torch.data import BatchIterator, MarkovLMDataset
    from repro_torch.launch.steps import make_grad_step, make_train_step
    from repro_torch.models import ssm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    b, s = TRAIN_SHAPE
    opt_cfg = AdamWConfig(lr_peak=3e-4, warmup_steps=1, total_steps=4)
    params = ssm.init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params)
    it = BatchIterator(MarkovLMDataset(cfg.vocab, s), b)
    batches = [it.next_global(dev) for _ in range(3)]
    step = make_train_step(cfg, opt_cfg, device=dev)
    params, opt, _ = step(params, opt, batches[0])  # warm-up
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batches[1])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    _report(f"train step {TRAIN_SHAPE} {cfg.dtype} remat {cfg.remat}",
            prof, wall)
    _report_ops(prof)
    del prof
    t0 = time.perf_counter()
    _, _, grads = make_grad_step(cfg, device=dev)(params, batches[2])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(opt_cfg, grads, opt, params)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"  halves (host clock, no profiler): gradient "
          f"{1e3 * (t1 - t0):.1f} ms, adamw_update {1e3 * (t2 - t1):.1f} ms")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import ssm

    if not torch.cuda.is_available():
        print("profile_mamba2: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config("mamba2-780m")
    params = ssm.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, PREFILL_SHAPE,
                           generator=gen, device=dev)
    prefill = make_prefill_step(cfg, device=dev)
    step = make_serve_step(cfg, device=dev)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if "--train" in sys.argv[1:]:
        del params, tokens
        train(dev, cfg, activities)
        return 0
    with torch.no_grad():
        prefill(params, {"tokens": tokens})  # warm-up
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        _report(f"prefill {PREFILL_SHAPE} {cfg.dtype}", prof, wall)
        del tokens
        cache = ssm.init_decode_cache(cfg, DECODE_BATCH, 1, device=dev)
        tok = torch.zeros((DECODE_BATCH, 1), dtype=torch.long, device=dev)
        _, cache = step(params, cache, {"tokens": tok})  # warm-up
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(DECODE_STEPS):
                _, cache = step(params, cache, {"tokens": tok})
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        _report(f"decode, {DECODE_STEPS} steps at batch {DECODE_BATCH} "
                f"{cfg.dtype}", prof, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
