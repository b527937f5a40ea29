#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases (each raises on failure; none is caught):

1. Card: name and power limit, torch/CUDA/nvcc versions; build every
   kernel from ``src/repro_torch/kernels/csrc`` (into ``build/``, one
   ``nvcc`` per source, all at once) and print nvcc's
   register/shared-memory/spill report.
2. Kernel vs. plain version on the card, on the same inputs, f32
   (tolerance 1e-5 relative to the largest |value|) and f64 (1e-12),
   with each plan's shared-memory bytes held to the kernel's own
   layout: the depth-1 kernel against ``ref.fused_stencil`` —
   diffusion at ranks 1-3, the MHD RHS and fused RK substep on a cube
   and a non-cubic box, and a ragged case (padded rows of 41 elements,
   one round short of threads) in f32, f64 and bf16, each printing
   its persistent launch (grid, ring, threads x outputs per thread,
   registers, spills); bf16 must equal its plain version bit for bit;
   the temporal kernel against
   ``ref.fused_stencil_steps`` — diffusion at depth 2 and 3, ranks 1-3,
   two selected fields, and the MHD pair (two RK3 substep φs, aux w);
   the stream kernel (``swc_stream``) against ``ref.fused_stencil`` /
   ``ref.fused_stencil_steps`` — diffusion at ranks 2 and 3, depth 1-3,
   on stream extents of many chunks and x extents off the default tile,
   two selected fields at depth 2, the MHD RHS on a cube and a
   non-cubic box, and stream axes cut into segments; at depth 1 (the
   ring body, ``csrc/stream_body.cuh``) also a ragged row pitch (41
   elements, chunks of 21 points) and stream extents of many ring
   passes, each depth-1 case printing its launch (grid, chunk and cross
   tile, the ring, threads x outputs per thread, registers, spills).
   Then the ensemble
   batch (B5, the member as an outer grid index of each kernel): B1 at
   B = 1, 3, 8 on ranks 1-3, B2 at depth 2 and 3, B3 at ranks 2-3 and
   depth 1-2 (a cut stream among them), the MHD RHS and fused substep
   with aux at B = 2, in f32 and f64, each against the batched plain
   version and each member against the unbatched launch on it, exactly.
   Then bf16 in the depth-1 kernel (B1b: ranks 1-3, two selected fields,
   B = 3; tolerance 2e-2) and the tc kernel (B4, ``fused_stencil_tc``)
   against ``ref.fused_stencil_tc[_steps]``: diffusion at ranks 1-3 in
   f32 and bf16 at depth 1 and 2, on tiles whose last 8-wide segment is
   ragged, two selected fields, B = 3 (each member equal to its
   unbatched launch), and the MHD RHS, fused substep (aux) and pair on
   a cube and a non-cubic box, the RHS and substep also at B = 3. Each
   tc case prints its launch: persistent grid, ring stages, staging
   route, registers.
   Then tc beyond radius 4 (orders 10 and 12, f32 and bf16, ranks 1-3),
   depths 9 and 12 on B2, B3 and B4 at 2-D (order 2, f32), and the B6
   cross-correlation (``csrc/xcorr1d.cu``) against ``ref.xcorr1d``: each
   strategy at unroll 4, f32 and f64, radii 0-1024, n = 2^20 + 123 (a
   ragged last block), each block's threads and shared bytes held to
   the kernel's own layout. Then B7 (``csrc/conv1d_depthwise.cu``)
   against ``ref.conv1d_depthwise``: the reference's sweep shapes
   (1,64,8,4), (3,100,16,4), (2,257,32,7), mamba2-780m's prefill launch
   (4, 8192, 3328) k = 4, a ragged s = 8193, and the strided xBC view of
   the (4, 8192, 6448) in-projection (bf16 two channels per thread, and
   one on a view starting on 2 bytes), f32 and bf16, activation none
   and silu, each block's threads held to the kernel's own.
3. Main path at full size, through the entry points a user calls, with
   the launch counters (total, per depth and per kernel) zeroed just
   before and read just after each run: MHD 256³ f32 RK3 with the fused
   axpy (3 launches per step), plain (3 per step), ``fuse_rk_pairs``
   (one depth-2 and one depth-1 launch per step) and plain on
   ``swc_stream`` (3 stream launches per step; the fused-axpy forms
   must raise there); 3-D diffusion at 512³ at depth 1, 2 and 3 (and 7
   steps at depth 3: a depth-1 remainder) on ``swc`` and on
   ``swc_stream``, 2-D diffusion at 8192² on ``swc_stream``, each held
   to ``swc`` at depth 1 (the ``swc`` runs at 8192² and 2^26 of the tc
   phase are counted too: one ``fused_stencil`` launch per step); an
   f64 Fourier mode checked against its exact
   discrete and analytic decay. Then ensemble serving
   (``repro_torch.launch.serve_sim.SimServer`` at its defaults: order 2,
   alpha 1, f32) on ``swc`` and on ``swc_stream``: after a warm-up batch
   of 8 per bucket, 16 requests of 8 steps alternating between 256³ and
   4096² members, batches of 8; every request ``ok`` on the strategy asked
   for, 8 launches of that strategy's kernel per batch, each request
   held to its per-member plain version on the card.
   The tc phase (``strategy="tc"``): MHD 256³ f32 plain and fused-axpy
   RK3 (3 ``fused_stencil_tc`` launches per step) and ``fuse_rk_pairs``
   at 128³ (one depth-2 and one depth-1 launch per step), each held to
   ``swc``; diffusion 512³ f32 at depth 1 and 2, bf16 at depth 1 (and
   bf16 on ``swc``, B1b, held to the plain bf16 version), 8192² and
   2^26 f32, each held to f32 ``swc``. The serve phase also runs
   ``SimServer(strategy="tc")``: 8 ``fused_stencil_tc`` launches per
   batch. The 1-D path: ``step_1d_xcorr`` on diffusion at 2^26, order 6,
   f32, 5 steps on each B6 strategy, exactly one ``xcorr1d`` launch per
   step (and no fused-stencil launch), held to ``simulate(...,
   strategy="swc")`` (B1 at rank 1) within 1e-5.
   The mamba2 phase: mamba2-780m at full width (48 layers, d_model
   1536, random init from a seeded generator on the card) through
   ``repro_torch.launch.steps``: the prefill (4, 8192) in bf16 with
   exactly 48 B7 launches and no fused-stencil or xcorr1d launch, its
   last logits held to the same prefill with ``use_pallas_conv=False``
   within 2e-2 of the largest |logit|; ``forward`` (with B7) against
   step-by-step ``decode_step`` from an empty cache in f32 on (2, 512)
   (two SSD chunks) within 2.2e-3 absolute (``DECODE_TOL`` says why not
   the reduced test's 5e-4); the
   serve loop of ``launch/serve.py`` at batch 4, 32 steps; prefill ms
   and tokens/s on the host clock after a warm-up.
4. Times (CUDA events, median after warm-up) of each kernel, its plain
   version and, for diffusion, ``F.conv{1,2,3}d`` with the merged
   stencil as a dense weight (S calls at depth S); the bound is
   max(bytes / memory rate, FLOPs / non-tensor rate) from the card's
   data sheet. Temporal and stream rows also print the tile, its shared
   memory, the modelled bytes per step (``swc`` and ``swc_stream``) and
   the redundant work (``repro_torch.core.trafficmodel``). Batched rows
   (B members in one launch) also time B unbatched launches of the same
   members in the same call (on ``swc_stream`` each cut into the
   segments the planner gives one member); their library is ``conv{2,3}d``
   with N = B.
   The serve phase's batches (order 2, B = 8, 256³ and 4096², on
   ``swc``, ``swc_stream`` and ``tc``) get rows of their own, each
   carrying its bucket's launch count from the serve phase. tc rows
   (diffusion 512³ f32 S=1, 2 and bf16, 8192², 2^26; MHD RHS and substep
   256³, pair 128³) take their bound at the route's tensor-core rate
   (989 TFLOP/s bf16 MMA; 67 TFLOP/s f64 MMA for f32 fields) and print
   the banded multiply-adds the MMAs issue beside the taps' own
   (``plan.tc_issued_macs``) and, at depth 1, the persistent grid (the
   kernel's occupancy times the SMs), the ring's stages, the staging
   route (16-byte ``cp.async``) and the registers from ptxas; the bf16
   rows time ``conv*d`` in bf16. Depth-1 ``swc`` rows (B1) print their
   persistent grid (blocks per SM x SMs), ring stages, threads, outputs
   per thread, registers and spills; its 2^26 and 8192² rows join the
   kernels line with their main-path launch counts. Depth-1
   ``swc_stream`` rows (B3) print their grid, chunk and cross tile, the
   ring (chunks, plane slots, bytes) or the one-buffer body, threads x
   outputs per thread, registers and spills.
   B6 rows: each strategy at n = 2^24 (fig07's size), f32 at radii
   1-1024 and f64 at r = 1 and 1024, and the 2^26 ``step_1d_xcorr``
   launch (the kernels line's B6 rows); bound max((2n + 2r + taps) ×
   itemsize / memory rate, 2 × taps × n / non-tensor rate); library
   ``F.conv1d`` (cuDNN) with ``cudnn.allow_tf32`` off.
   B7 rows (the kernels line's): the strided xBC view at the prefill
   launch (4, 8192, 3328), k = 4, bf16 and f32, with launches per
   prefill; bound max(((b(s+k-1) + k)c + bsc) × itemsize / memory
   rate, 2kbsc / non-tensor f32 rate); library ``F.conv1d(groups=c,
   padding=k-1)`` (cuDNN, TF32 off) on a contiguous (b, c, s) copy,
   whose copy time is printed apart.
   Each phase prints its seconds.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_stencil.cu"
REPLACES = "src/repro/kernels/emit.py:207"  # _kernel_pipelined (+ _block_derivs :73)
TEMPORAL_SOURCE = "src/repro_torch/kernels/csrc/fused_stencil_temporal.cu"
TEMPORAL_REPLACES = "src/repro/kernels/emit.py:271"  # _kernel_temporal (+ _temporal_sweeps :242)
STREAM_SOURCE = "src/repro_torch/kernels/csrc/fused_stencil_stream.cu"
STREAM_REPLACES = "src/repro/kernels/emit.py:585"  # _kernel_stream (via _fused_stream :687)
STREAM = "fused_stencil_stream"
BATCH_REPLACES = "src/repro/kernels/emit.py:345"  # _fused_batched (+ _member_phi :318)
TC_SOURCE = "src/repro_torch/kernels/csrc/fused_stencil_tc.cu"
TC_REPLACES = "src/repro/kernels/emit.py:233"  # _kernel_tc (+ _block_derivs_tc :153)
TC = "fused_stencil_tc"
XCORR_SOURCE = "src/repro_torch/kernels/csrc/xcorr1d.cu"
# xcorr1d_pallas (+ _kernel_baseline :52, _kernel_elementwise :56, _mac_loop :35)
XCORR_REPLACES = "src/repro/kernels/stencil1d.py:73"
# B6's strategies as the paper's Figs. 8-9 run them: unroll 4 (baseline
# ignores it, as the reference's does).
XCORR_STRATEGIES = (("baseline", 4), ("pointwise", 4), ("elementwise", 4))
XCORR_RADII = (0, 1, 5, 32, 200, 1024)
CONV_SOURCE = "src/repro_torch/kernels/csrc/conv1d_depthwise.cu"
# conv1d_depthwise_pallas (+ _kernel :26)
CONV_REPLACES = "src/repro/kernels/conv1d_depthwise.py:36"
# mamba2-780m's prefill at the cut size (registry prefill_32k is (32, 32768))
# and the decode-consistency prompt (two SSD chunks of 256).
PREFILL_SHAPE = (4, 8192)
DECODE_SHAPE = (2, 512)
LM_BATCH, LM_STEPS = 4, 32  # launch/serve.py's defaults
# Decode against forward at full width in f32, max |err| (absolute).
# tests/test_system.py:85 holds 5e-4 at the reduced config (4 layers,
# chunk 16); at 48 layers and chunk 256 the chunked form's f32
# exp(A_cs_i - A_cs_j) rounds unlike the recurrence and depth amplifies
# it (the reference's JAX code too: tools/mamba2_drift.py decode). On the
# H100, tools/mamba2_decode_limit.py reads 8.395e-4 to 1.110e-3 over four
# seeds, and 2.902e-1 to 7.523 with a fault planted in the decode path
# (conv window frozen, state decaying twice, state in bf16): the limit
# is twice the largest sound reading.
DECODE_TOL = 2.2e-3
TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 2e-2}
# Tensor-core rates of the tc routes (data sheet, SXM): bf16 MMA; the
# f32 fields contract on the f64 MMA.
TC_RATES = {"bfloat16": 989e12, "float32": 67e12}

# Data-sheet rates: (memory B/s, non-tensor f32 FLOP/s, non-tensor f64 FLOP/s).
CARD_RATES = {
    "H100 PCIe": (2.0e12, 51e12, 26e12),
    "H100 NVL": (3.9e12, 60e12, 30e12),
    "H100": (3.35e12, 67e12, 34e12),  # SXM5
    "H200": (4.8e12, 67e12, 34e12),
}


def card_rates(name: str) -> tuple[float, float, float]:
    for key, rates in CARD_RATES.items():
        if key in name:
            return rates
    raise RuntimeError(f"no data-sheet rates for {name!r}")


def run(cmd: list[str]) -> str:
    return subprocess.run(
        cmd, capture_output=True, text=True, check=True
    ).stdout.strip()


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|), bf16 compared in f32."""
    import torch

    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        a, b = a.float(), b.float()
    diff = float((a - b).abs().max())
    return diff, diff / max(float(b.abs().max()), 1e-300)


def check(label: str, got, want, dtype: str) -> float:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape} != {want.shape}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite kernel output")
    err, rel = rel_err(got, want)
    ok = rel <= TOL[dtype]
    print(f"  {label:<44} max|err| {err:.3e}  rel {rel:.3e}  "
          f"(tol {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: rel err {rel:.3e} > {TOL[dtype]}")
    return err


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def diffusion_case(shape, dtype, device, block=None, unroll=1, seed=0,
                   fuse_steps=1, strategy="swc", segments=None, batch=None,
                   accuracy=6):
    """(f_padded, ops, phi, plan, aux) of ``fuse_steps`` diffusion
    steps of order ``accuracy`` in one launch; ``segments`` overrides
    the stream planner's;
    ``batch`` members (seeds ``seed``, ``seed + 1``, ...) make a
    (batch, 1, *padded) ensemble."""
    import dataclasses

    import torch

    from repro_torch.core.boundary import pad
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.physics.diffusion import DiffusionProblem

    prob = DiffusionProblem(shape, accuracy=accuracy)
    op = prob.step_op(strategy, block=block, fuse_steps=fuse_steps,
                      device=device)
    if batch is None:
        f = prob.init_field(seed, device=device, dtype=dtype)
    else:
        f = torch.stack([prob.init_field(seed + m, device=device, dtype=dtype)
                         for m in range(batch)])
    fp = pad(f, [r * fuse_steps for r in op.radius_per_axis], "periodic",
             spatial_axes=range(f.ndim - len(shape), f.ndim))
    plan = plan_for_nd(op.ops, tuple(fp.shape), 1, strategy=strategy,
                       block=block, dtype=dtype, unroll=unroll,
                       fuse_steps=fuse_steps)
    if segments is not None:
        plan = dataclasses.replace(plan, segments=segments)
    return fp, op.ops, op.phi, plan, None


def select_case(shape, dtype, device, fuse_steps, seed=0, strategy="swc",
                batch=None):
    """Two random fields through the whole order-6 derivative set, φ
    selecting ``dxx``: the select kind with more than one field
    (``batch`` members of them, when given)."""
    import torch

    from repro_torch.core.stencil import derivative_operator_set
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.kernels.phi import select_phi

    ops = derivative_operator_set(len(shape), 6, 0.3)
    g = torch.Generator(device="cpu").manual_seed(seed)
    lead = () if batch is None else (batch,)
    padded = lead + (2,) + tuple(n + 6 * fuse_steps for n in shape)
    fp = torch.rand(padded, generator=g, dtype=torch.float64).to(
        device=device, dtype=getattr(torch, dtype))
    plan = plan_for_nd(ops, padded, 2, strategy=strategy, dtype=dtype,
                       fuse_steps=fuse_steps)
    return fp, ops, select_phi("dxx"), plan, None


def mhd_case(shape, dtype, device, substep, block=None, unroll=1,
             smooth=True, seed=0, strategy="swc", batch=None):
    """(f_padded, ops, phi, plan, aux) of one MHD RHS or RK substep;
    ``batch`` members (seeds ``seed``, ``seed + 1``, ...) make an
    ensemble, aux then (batch, 8, *shape). ``block`` defaults to the
    solver's: the planner's on ``swc`` and ``tc`` (depth 1), else
    ``MHDSolver.block``."""
    import torch

    from repro_torch.core.boundary import pad
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.physics import mhd

    solver = mhd.MHDSolver(tuple(shape), strategy="swc", device=device)
    if block is None and strategy == "swc_stream":
        block = solver.block
    init = solver.init_smooth if smooth else solver.init_fields
    kw = dict(amplitude=1e-2) if smooth else {}
    if batch is None:
        f = init(seed, dtype=dtype, **kw)
    else:
        f = torch.stack([init(seed + m, dtype=dtype, **kw)
                         for m in range(batch)])
    ops = solver.operator_set
    fp = pad(f, ops.radius_per_axis(), "periodic",
             spatial_axes=range(f.ndim - 3, f.ndim))
    if substep:
        dt = float(solver.cfl_dt(f if batch is None else f[0]))
        phi = mhd.mhd_substep_device_phi(
            solver.params, mhd.RK3_ALPHA[1], mhd.RK3_BETA[1], dt
        )
        g = torch.Generator(device="cpu").manual_seed(seed + 1)
        aux = (1e-3 * torch.rand(f.shape, generator=g, dtype=torch.float64)
               ).to(device=device, dtype=f.dtype)
    else:
        phi, aux = mhd.mhd_rhs_device_phi(solver.params), None
    plan = plan_for_nd(
        ops, tuple(fp.shape), phi.n_out(8),
        aux_shape=None if aux is None else tuple(aux.shape),
        strategy=strategy, block=block, dtype=dtype, unroll=unroll,
        max_threads=phi.max_threads, n_slots=len(phi.operators),
    )
    return fp, ops, phi, plan, aux


def mhd_pair_case(shape, dtype, device, substeps=(1, 2), block=(1, 8, 32),
                  smooth=True, seed=0, strategy="swc"):
    """(f_padded, ops, phis, plan, aux) of two fused-axpy RK3 substeps
    in one depth-2 launch, aux = w. Substeps (1, 2), both with α ≠ 0,
    read the staged w in both sweeps; the solver's pair is (0, 1)."""
    import torch

    from repro_torch.core.boundary import pad
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.physics import mhd

    solver = mhd.MHDSolver(tuple(shape), strategy="swc", device=device)
    if smooth:
        f = solver.init_smooth(seed, amplitude=1e-2, dtype=dtype)
    else:
        f = solver.init_fields(seed, dtype=dtype)
    ops = solver.operator_set
    fp = pad(f, 6, "periodic", spatial_axes=(1, 2, 3))
    dt = float(solver.cfl_dt(f))
    phis = tuple(
        mhd.mhd_substep_device_phi(
            solver.params, mhd.RK3_ALPHA[i], mhd.RK3_BETA[i], dt)
        for i in substeps
    )
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    w = (1e-3 * torch.rand(f.shape, generator=g, dtype=torch.float64)
         ).to(device=device, dtype=f.dtype)
    aux = pad(w, 3, "periodic", spatial_axes=(1, 2, 3))
    plan = plan_for_nd(ops, tuple(fp.shape), 16, aux_shape=tuple(aux.shape),
                       strategy=strategy, block=block, dtype=dtype,
                       fuse_steps=2, max_threads=256, n_slots=10)
    return fp, ops, phis, plan, aux


def mhd_rhs_twice_case(shape, dtype, device, seed=0):
    """(f_padded, ops, phi, plan, aux) of the MHD RHS applied twice in
    one depth-2 launch (a self-map without aux)."""
    from repro_torch.core.boundary import pad
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.physics import mhd

    solver = mhd.MHDSolver(tuple(shape), strategy="swc", device=device)
    f = solver.init_smooth(seed, amplitude=1e-2, dtype=dtype)
    fp = pad(f, 6, "periodic", spatial_axes=(1, 2, 3))
    plan = plan_for_nd(solver.operator_set, tuple(fp.shape), 8,
                       block=(1, 8, 32), dtype=dtype, fuse_steps=2,
                       max_threads=256)
    return (fp, solver.operator_set, mhd.mhd_rhs_device_phi(solver.params),
            plan, None)


def ptxas_usage(name: str) -> dict[str, tuple[int, int]]:
    """(registers, bytes of spill stores) per kernel entry (mangled name)
    of ``csrc/<name>.cu``'s last build, from nvcc's ``-Xptxas -v``
    report."""
    from repro_torch.kernels import build

    usage, entry, spill = {}, None, 0
    for line in build.ptxas_report(name).splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], 0
        elif "spill stores" in line and entry is not None:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "registers" in line and entry is not None:
            usage[entry] = (int(line.split("Used")[1].split()[0]), spill)
            entry = None
    return usage


def _usage_of(name: str, key: str) -> str:
    found = [v for k, v in ptxas_usage(name).items() if key in k]
    if not found:
        return "? registers"
    regs, spill = found[0]
    return f"{regs} registers, {spill} B spilled"


def tc_launch_info(plan, phi) -> str:
    """The depth-1 tc launch of ``plan``: its persistent grid (the
    kernel's occupancy), ring stages, staging route and registers."""
    import torch

    from repro_torch.kernels import emit

    if not plan.tc_depth1:
        return f"temporal body (depth {plan.fuse_steps}), grid of tiles"
    grid = emit.launch_grid(plan, phi.kind_id,
                            torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t = "f" if plan.dtype == "float32" else "13__nv_bfloat16"
    key = f"tc_d1_kernelI{t}Li{phi.kind_id}E"
    return (f"persistent grid {grid} ({grid / sms:.2f} per SM, "
            f"{plan.walk_items} steps of {plan.tc_step.extent}), "
            f"{plan.stage_buffers}-stage ring of {plan.tc_step.buffer_bytes} "
            f"B windows, 16-byte cp.async staging, {plan.threads} threads, "
            f"{_usage_of(TC, key)}")


SWC_TYPE_KEYS = {"float32": "f", "float64": "d", "bfloat16": "13__nv_bfloat16"}


def swc_launch_info(plan, phi) -> str:
    """The depth-1 swc launch of ``plan`` (B1): its persistent grid (the
    kernel's resident blocks per SM times the SMs), ring stages, threads,
    outputs per thread, registers and spills."""
    import torch

    from repro_torch.kernels import emit

    grid = emit.launch_grid(plan, phi.kind_id, torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    key = f"fused_stencil_kernelI{SWC_TYPE_KEYS[plan.dtype]}Li{phi.kind_id}E"
    return (f"persistent grid {grid} ({grid / sms:.2f} per SM x {sms} SMs, "
            f"{plan.walk_items} steps of {plan.swc_step.extent}), "
            f"{plan.stage_buffers}-stage ring of "
            f"{plan.swc_step.buffer_bytes} B windows, {plan.threads} "
            f"threads x {plan.outputs_per_thread} outputs, "
            f"{_usage_of('fused_stencil', key)}")


def stream_launch_info(plan, phi) -> str:
    """The ``swc_stream`` launch of ``plan`` (B3): its grid (cross tiles x
    members x segments), chunk and cross tile, the ring on the depth-1
    body (chunks it holds, plane slots, bytes) or the one-buffer body,
    threads x outputs per thread, registers and spills."""
    import torch

    kind, t = phi.kind_id, SWC_TYPE_KEYS[plan.dtype]
    tiles = 1
    for n, b in zip(plan.interior[1:], plan.block[1:]):
        tiles *= n // b
    grid = tiles * plan.batch * plan.segments
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    head = (f"grid {grid} ({grid / sms:.2f} per SM: {tiles} cross tiles x "
            f"{plan.batch} member(s) x {plan.segments} segment(s)), chunk "
            f"{plan.block[0]}, cross tile {plan.block[1:]}")
    if getattr(plan, "stream_depth1", False):
        ring = plan.stream_ring
        u = plan.outputs_per_thread
        key = f"stream_d1_kernelI{t}Li{kind}ELi{u}E"
        return (f"{head}, ring body: {plan.stage_buffers} chunk(s) in a ring "
                f"of {ring.period} plane slots ({ring.ring_bytes} B, "
                f"{plan.smem_bytes} B shared), 16-byte cp.async, "
                f"{plan.threads} threads x {u} outputs, "
                f"{_usage_of(STREAM, key)}")
    key = f"stream_kernelI{t}Li{kind}E"
    return (f"{head}, one-buffer body ({plan.smem_bytes} B shared), "
            f"{plan.threads} threads x 1 output, {_usage_of(STREAM, key)}")


def plain(case):
    """The plain PyTorch version of a case's launch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.phi import phi_sequence

    fp, ops, phi, plan, aux = case
    phis = phi_sequence(phi, plan.fuse_steps)
    batched = fp.ndim == plan.rank + 2
    tc = plan.strategy == "tc"
    if plan.fuse_steps == 1:
        fn = ref.fused_stencil_batched if batched else ref.fused_stencil
        return fn(fp, ops, phis[0].torch_fn, aux=aux, tc=tc)
    fn = ref.fused_stencil_steps_batched if batched else ref.fused_stencil_steps
    return fn(fp, ops, [p.torch_fn for p in phis], plan.fuse_steps, aux=aux,
              tc=tc)


def compare(label, case, dtype):
    from repro_torch.kernels import emit

    import torch

    fp, ops, phi, plan, aux = case
    layout = emit.kernel_smem_bytes(plan)
    if layout != plan.smem_bytes:
        raise AssertionError(
            f"{label}: plan.smem_bytes {plan.smem_bytes} != the kernel's "
            f"layout {layout}")
    got = emit.fused_stencil_swc(fp, ops, phi, plan, aux=aux)
    if plan.strategy == "tc":
        print(f"    tc: {tc_launch_info(plan, phi)}")
    elif plan.swc_depth1:
        print(f"    swc: {swc_launch_info(plan, phi)}")
    elif plan.stream_axis is not None and plan.fuse_steps == 1:
        print(f"    stream: {stream_launch_info(plan, phi)}")
    seg = f" seg{plan.segments}" if plan.segments > 1 else ""
    want = plain(case)
    check(f"{label} {dtype} S{plan.fuse_steps} tile{plan.block}"
          f"u{plan.unroll}{seg} {plan.smem_bytes}B", got, want, dtype)
    if plan.swc_depth1 and dtype == "bfloat16" and not torch.equal(got, want):
        raise AssertionError(f"{label}: bf16 swc differs from its plain "
                             "version (it rounds each product and sum as "
                             "the plain version does)")
    return got


def compare_batched(label, case, dtype):
    """A batched case against the batched plain version, and each member
    against the unbatched launch on that member: equal bit for bit, since
    its block runs the unbatched body on the same values."""
    import dataclasses

    import torch

    from repro_torch.kernels import emit

    fp, ops, phi, plan, aux = case
    got = compare(f"{label} B={plan.batch} gz{plan.grid_z}", case, dtype)
    solo = dataclasses.replace(plan, batch=1)
    for m in range(plan.batch):
        one = emit.fused_stencil_swc(fp[m], ops, phi, solo,
                                     aux=None if aux is None else aux[m])
        if not torch.equal(got[m], one):
            diff = float((got[m] - one).abs().max())
            raise AssertionError(f"{label}: member {m} of the batched launch "
                                 f"differs from its unbatched launch by {diff}")
    print(f"    each of {plan.batch} member(s) equals its unbatched launch "
          "exactly")


def xcorr_inputs(n, radius, dtype, device, seed=0):
    """(f_padded, g) of n outputs at ``radius``: standard normal draws
    from a seeded CPU generator, moved to ``device``."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    f = torch.randn(n + 2 * radius, generator=gen, dtype=torch.float64)
    g = torch.randn(2 * radius + 1, generator=gen, dtype=torch.float64)
    dt = getattr(torch, dtype)
    return f.to(device=device, dtype=dt), g.to(device=device, dtype=dt)


def phase_card():
    import torch

    from repro_torch.kernels import build

    print("== phase 1: card and build")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("  " + run([build.nvcc_path(), "--version"]).splitlines()[-1])
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name in built:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas: " + line.strip())
    return smi


def phase_parity(dev):
    print("== phase 2: kernel vs plain version on the card")
    for dtype in ("float32", "float64"):
        compare("diffusion (65536,)", diffusion_case((65536,), dtype, dev),
                dtype)
        compare("diffusion (512, 384)",
                diffusion_case((512, 384), dtype, dev), dtype)
        compare("diffusion (64, 96, 128)",
                diffusion_case((64, 96, 128), dtype, dev), dtype)
        compare("diffusion (64, 96, 128)",
                diffusion_case((64, 96, 128), dtype, dev, block=(2, 8, 32),
                               unroll=2), dtype)
        for shape in ((64, 64, 64), (48, 64, 80)):
            for substep in (False, True):
                name = "mhd_substep" if substep else "mhd_rhs"
                compare(f"{name} {shape}",
                        mhd_case(shape, dtype, dev, substep), dtype)
        compare("mhd_substep (48, 64, 80)",
                mhd_case((48, 64, 80), dtype, dev, True, block=(1, 8, 16),
                         unroll=2), dtype)
    print("  -- temporal kernel vs ref.fused_stencil_steps")
    for dtype in ("float32", "float64"):
        for depth in (2, 3):
            for shape in ((65536,), (512, 384), (64, 96, 128)):
                compare(f"diffusion {shape}",
                        diffusion_case(shape, dtype, dev, fuse_steps=depth),
                        dtype)
            compare("select dxx, 2 fields (48, 64, 80)",
                    select_case((48, 64, 80), dtype, dev, depth), dtype)
        for shape in ((64, 64, 64), (48, 64, 80)):
            compare(f"mhd_substep pair {shape}",
                    mhd_pair_case(shape, dtype, dev), dtype)
        compare("mhd_rhs twice (48, 64, 80)",
                mhd_rhs_twice_case((48, 64, 80), dtype, dev), dtype)
    print("  -- stream kernel (swc_stream) vs ref.fused_stencil[_steps]")
    for dtype in ("float32", "float64"):
        for depth in (1, 2, 3):
            # Many chunks along the stream axis; x off the default tile
            # (120 = 4 x 30, 400 = 8 x 50).
            for shape in ((512, 400), (64, 96, 120)):
                compare(f"stream diffusion {shape}",
                        diffusion_case(shape, dtype, dev, fuse_steps=depth,
                                       strategy="swc_stream"), dtype)
        compare("stream select dxx, 2 fields (48, 64, 80)",
                select_case((48, 64, 80), dtype, dev, 2,
                            strategy="swc_stream"), dtype)
        for shape in ((64, 64, 64), (48, 64, 80)):
            compare(f"stream mhd_rhs {shape}",
                    mhd_case(shape, dtype, dev, False,
                             strategy="swc_stream"), dtype)
        for shape, depth, seg in (((1024, 96), 1, 4), ((192, 64, 120), 2, 4),
                                  ((256, 64, 64), 1, 8)):
            compare(f"stream diffusion {shape} in segments",
                    diffusion_case(shape, dtype, dev, fuse_steps=depth,
                                   strategy="swc_stream", segments=seg),
                    dtype)
    print("  -- depth-1 stream ring body at a ragged row pitch (x 35 of a "
          "41-element row, chunks of 21 points for 1024 thread outputs), "
          "stream extents of many ring passes")
    for dtype in ("float32", "float64"):
        compare("stream diffusion (48, 18, 35)",
                diffusion_case((48, 18, 35), dtype, dev, block=(2, 3, 7),
                               strategy="swc_stream"), dtype)
        compare("stream diffusion (2048, 35)",
                diffusion_case((2048, 35), dtype, dev, block=(3, 35),
                               strategy="swc_stream", accuracy=2), dtype)
        compare("stream diffusion (4096, 256)",
                diffusion_case((4096, 256), dtype, dev, strategy="swc_stream",
                               segments=2), dtype)
    print("  -- ensemble batch (B5): batched kernel vs batched plain version, "
          "each member vs its unbatched launch")
    for dtype in ("float32", "float64"):
        for batch in (1, 3, 8) if dtype == "float32" else (3,):
            for shape in ((65536,), (512, 384), (64, 96, 128)):
                compare_batched(f"diffusion {shape}",
                                diffusion_case(shape, dtype, dev, batch=batch),
                                dtype)
        for depth in (2, 3):
            compare_batched("diffusion (64, 96, 128)",
                            diffusion_case((64, 96, 128), dtype, dev,
                                           fuse_steps=depth, batch=3), dtype)
        compare_batched("select dxx, 2 fields (48, 64, 80)",
                        select_case((48, 64, 80), dtype, dev, 2, batch=3),
                        dtype)
        for depth in (1, 2):
            for shape in ((512, 400), (64, 96, 120)):
                compare_batched(f"stream diffusion {shape}",
                                diffusion_case(shape, dtype, dev,
                                               fuse_steps=depth, batch=3,
                                               strategy="swc_stream"), dtype)
        compare_batched("stream diffusion (1024, 96) in segments",
                        diffusion_case((1024, 96), dtype, dev, batch=3,
                                       strategy="swc_stream", segments=4),
                        dtype)
        for substep in (False, True):
            name = "mhd_substep" if substep else "mhd_rhs"
            compare_batched(f"{name} (64, 64, 64)",
                            mhd_case((64,) * 3, dtype, dev, substep, batch=2),
                            dtype)
    print("  -- bf16 in the depth-1 kernel (B1b) vs ref.fused_stencil in bf16")
    for shape in ((65536,), (512, 384), (64, 96, 128)):
        compare(f"diffusion {shape}", diffusion_case(shape, "bfloat16", dev),
                "bfloat16")
    compare("select dxx, 2 fields (48, 64, 80)",
            select_case((48, 64, 80), "bfloat16", dev, 1), "bfloat16")
    compare_batched("diffusion (64, 96, 128)",
                    diffusion_case((64, 96, 128), "bfloat16", dev, batch=3),
                    "bfloat16")
    print("  -- depth-1 swc at a ragged row pitch (41 elements, unroll 5, a "
          "step of 210 points for 1024 thread outputs)")
    for dtype in ("float32", "float64", "bfloat16"):
        compare("diffusion (12, 18, 35)",
                diffusion_case((12, 18, 35), dtype, dev, block=(2, 3, 7),
                               unroll=5), dtype)
    print("  -- tc kernel vs ref.fused_stencil_tc[_steps] (f32 on the f64 "
          "MMA, bf16 on the bf16 MMA)")
    for dtype in ("float32", "bfloat16"):
        for depth in (1, 2):
            # Tiles off the 8-wide segment: x tiles 2002 (of 30030), 50
            # (of 400) and 30 (of 120), so the last segment is ragged.
            for shape in ((65536,), (30030,), (512, 400), (64, 96, 120)):
                compare(f"tc diffusion {shape}",
                        diffusion_case(shape, dtype, dev, fuse_steps=depth,
                                       strategy="tc"), dtype)
            compare("tc select dxx, 2 fields (48, 64, 80)",
                    select_case((48, 64, 80), dtype, dev, depth,
                                strategy="tc"), dtype)
            for shape in ((65536,), (512, 384), (64, 96, 128)):
                compare_batched(f"tc diffusion {shape}",
                                diffusion_case(shape, dtype, dev, batch=3,
                                               fuse_steps=depth,
                                               strategy="tc"), dtype)
    for shape in ((64, 64, 64), (48, 64, 80)):
        for substep in (False, True):
            name = "mhd_substep" if substep else "mhd_rhs"
            compare(f"tc {name} {shape}",
                    mhd_case(shape, "float32", dev, substep, strategy="tc"),
                    "float32")
        compare(f"tc mhd_substep pair {shape}",
                mhd_pair_case(shape, "float32", dev, strategy="tc"),
                "float32")
    for substep in (False, True):
        name = "mhd_substep" if substep else "mhd_rhs"
        compare_batched(f"tc {name} (64, 64, 64)",
                        mhd_case((64,) * 3, "float32", dev, substep, batch=3,
                                 strategy="tc"), "float32")
    print("  -- tc beyond radius 4 (C1): orders 10 and 12, the band of "
          "8 + 2r rows in more than one k-step")
    for dtype in ("float32", "bfloat16"):
        for shape, order in (((30030,), 12), ((512, 400), 10),
                             ((64, 96, 120), 10), ((64, 96, 120), 12)):
            compare(f"tc diffusion o{order} {shape}",
                    diffusion_case(shape, dtype, dev, strategy="tc",
                                   accuracy=order), dtype)
    print("  -- depths 9 and 12 (C2): B2, B3 and B4 at 2-D, order 2, the "
          "phi parameter rows in a device buffer")
    for depth in (9, 12):
        for shape in ((64, 64), (512, 400)):
            for strategy in ("swc", "swc_stream", "tc"):
                compare(f"{strategy} diffusion o2 {shape}",
                        diffusion_case(shape, "float32", dev,
                                       fuse_steps=depth, strategy=strategy,
                                       accuracy=2), "float32")
    parity_xcorr(dev)
    parity_conv1d(dev)


def conv_inputs(shape, k, dtype, device, seed=0, row=None, offset=0):
    """(x, w): x (b, s, c) standard normal, w (k, c); with ``row``, x is
    the column view ``[..., offset:offset + c]`` of a (b, s, row) tensor
    (mamba2's xBC inside its in-projection)."""
    import torch

    b, s, c = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    full = torch.randn((b, s, row or c), generator=gen, device=device)
    x = full.to(dt)[..., offset:offset + c]
    w = torch.randn((k, c), generator=gen, device=device).to(dt)
    return x, w


def parity_conv1d(dev):
    """B7 (``csrc/conv1d_depthwise.cu``) against ``ref.conv1d_depthwise``:
    the reference's sweep shapes, mamba2-780m's prefill launch (4, 8192,
    3328) with k = 4, a ragged s, and the strided xBC view of the
    (4, 8192, 6448) in-projection (bf16 two channels per thread, and one
    when the view starts on 2 bytes), f32 and bf16, activation none and
    silu; each block's threads held to the kernel's own layout. "=" marks
    an output equal to the plain version's bit for bit, "~" one within
    the tolerance only."""
    import torch

    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    print("  -- B7 conv1d_depthwise vs ref.conv1d_depthwise")
    b, s = PREFILL_SHAPE
    cases = [((1, 64, 8), 4, 128, {}), ((3, 100, 16), 4, 128, {}),
             ((2, 257, 32), 7, 128, {}),
             ((b, s, 3328), 4, 512, {}), ((b, s + 1, 3328), 4, 512, {}),
             ((b, s, 3328), 4, 512, dict(row=6448, offset=3072)),
             ((b, s, 3328), 4, 512, dict(row=6448, offset=3073))]
    for dtype in ("float32", "bfloat16"):
        for i, (shape, k, block_seq, view) in enumerate(cases):
            x, w = conv_inputs(shape, k, dtype, dev, seed=i, **view)
            vec = kc.vector_width(x, w)
            grid, threads = kc.launch_layout(*shape, block_seq, vec)
            if kc.kernel_threads(shape[2], vec) != threads:
                raise AssertionError(
                    f"conv1d {shape}: the kernel's threads differ from "
                    "conv1d_depthwise.py's")
            for act in ("none", "silu"):
                got = kops.conv1d_depthwise(x, w, activation=act,
                                            block_seq=block_seq)
                want = ref.conv1d_depthwise(x, w, act)
                tag = f" view row {view['row']} +{view['offset']}" \
                    if view else ""
                same = "=" if torch.equal(got, want) else "~"
                check(f"conv1d {shape} k={k} {act}{tag} vec{vec} "
                      f"grid{grid} {same}", got, want, dtype)
                del got, want
            del x, w


def parity_xcorr(dev):
    """B6 (``csrc/xcorr1d.cu``) against ``ref.xcorr1d`` for each strategy,
    f32 and f64, radii 0 to 1024, n = 2^20 + 123 (a ragged last block of
    the default 2048 outputs), each launch's threads and shared bytes held
    to the kernel's own layout."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import xcorr1d as kx

    n, block = (1 << 20) + 123, 2048
    print(f"  -- B6 xcorr1d vs ref.xcorr1d, n = {n}, block_size {block}")
    for dtype in ("float32", "float64"):
        for r in XCORR_RADII:
            f, g = xcorr_inputs(n, r, dtype, dev, seed=r)
            want = ref.xcorr1d(f, g)
            for strategy, unroll in XCORR_STRATEGIES:
                layout = kx.kernel_layout(2 * r + 1, block, strategy, unroll,
                                          dtype)
                if layout != (kx.launch_threads(block, strategy, unroll),
                              kx.smem_bytes(2 * r + 1, block, dtype)):
                    raise AssertionError(
                        f"xcorr1d {strategy} r={r}: the kernel's layout "
                        f"{layout} differs from xcorr1d.py's")
                got = kops.xcorr1d(f, g, strategy=strategy,
                                   block_size=block, unroll=unroll)
                check(f"xcorr1d {strategy} u{unroll} r={r} {layout[0]}thr "
                      f"{layout[1]}B", got, want, dtype)
            del f, g, want


def counted(fn, kernel=None):
    """(fn(), host seconds, launches by depth), the launch counters set
    to 0 just before and read just after, the card synchronised at both
    ends. With ``kernel``, every launch must have gone to that kernel
    (the per-kernel count)."""
    import torch

    from repro_torch.kernels import emit

    torch.cuda.synchronize()
    emit.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_depth = dict(emit.fused_stencil_swc.launches_by_depth)
    by_kernel = dict(emit.fused_stencil_swc.launches_by_kernel)
    total = emit.fused_stencil_swc.launches
    if total != sum(by_depth.values()) or total != sum(by_kernel.values()):
        raise AssertionError("launch total and per-depth/kernel counts "
                             "disagree")
    if kernel is not None and by_kernel != {kernel: total}:
        raise AssertionError(f"launches by kernel {by_kernel}, want all "
                             f"{total} on {kernel}")
    return out, wall, by_depth


def phase_main_path(dev):
    import torch

    from repro_torch.physics.diffusion import DiffusionProblem, simulate
    from repro_torch.physics.mhd import MHDSolver

    print("== phase 3: main path at full size")
    launches = {}
    n_steps = 3
    results = {}
    for kind, form, want in (
        ("mhd_substep", dict(fuse_rk_axpy=True), {1: 3 * n_steps}),
        ("mhd_rhs", {}, {1: 3 * n_steps}),
        ("mhd pair", dict(fuse_rk_pairs=True), {2: n_steps, 1: n_steps}),
    ):
        solver = MHDSolver((256,) * 3, strategy="swc", device=dev, **form)
        f0 = solver.init_fields(seed=0, dtype="float32")
        dt = float(solver.cfl_dt(f0))
        solver.step(f0, dt)  # warm-up: first launches load the modules

        def run():
            f = f0
            for _ in range(n_steps):
                f = solver.step(f, dt)
            return f

        f, wall, by_depth = counted(run)
        if by_depth != want:
            raise AssertionError(f"{kind}: launches {by_depth}, want {want}")
        if f.shape != (8, 256, 256, 256) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{kind}: bad MHD state")
        launches[kind] = by_depth.get(2, by_depth[1])
        results[kind] = f
        print(f"  MHD 256^3 f32 RK3 {form or 'plain'}: {n_steps} steps "
              f"dt={dt:.4e}, launches by depth {by_depth}, "
              f"{1e3 * wall / n_steps:.2f} ms/step (host clock)")
    solver = MHDSolver((256,) * 3, strategy="swc_stream", device=dev)
    f0 = solver.init_fields(seed=0, dtype="float32")
    dt = float(solver.cfl_dt(f0))
    solver.step(f0, dt)

    def run_stream():
        f = f0
        for _ in range(n_steps):
            f = solver.step(f, dt)
        return f

    f, wall, by_depth = counted(run_stream, kernel=STREAM)
    if by_depth != {1: 3 * n_steps}:
        raise AssertionError(f"mhd stream: launches {by_depth}")
    if f.shape != (8, 256, 256, 256) or not bool(torch.isfinite(f).all()):
        raise AssertionError("mhd stream: bad MHD state")
    launches["stream mhd_rhs"] = by_depth[1]
    results["mhd_rhs stream"] = f
    print(f"  MHD 256^3 f32 RK3 plain on swc_stream: {n_steps} steps, "
          f"{by_depth[1]} stream launches, {1e3 * wall / n_steps:.2f} "
          "ms/step (host clock)")
    for kind in ("mhd_rhs", "mhd pair", "mhd_rhs stream"):
        _, rel = rel_err(results[kind], results["mhd_substep"])
        print(f"  {kind} vs fused-axpy RK3 after {n_steps} steps: "
              f"rel {rel:.3e}")
        if rel > 1e-5:
            raise AssertionError(f"{kind}: the RK3 forms disagree")
    del results, f
    for form in ("fuse_rk_axpy", "fuse_rk_pairs"):
        solver = MHDSolver((64,) * 3, strategy="swc_stream", device=dev,
                           **{form: True})
        try:
            solver.step(solver.init_fields(dtype="float32"), 1e-3)
        except ValueError as err:
            print(f"  MHD swc_stream with {form}: ValueError ({err})")
        else:
            raise AssertionError(f"swc_stream with {form} did not raise")

    prob = DiffusionProblem((512,) * 3)
    f0 = prob.init_field(seed=0, device=dev)
    out, wall, by_depth = counted(
        lambda: simulate(prob, f0, 5, strategy="swc", device=dev))
    if by_depth != {1: 5}:
        raise AssertionError(f"diffusion: launches {by_depth}")
    launches["select"] = by_depth[1]
    if out.shape != f0.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError("diffusion: bad state")
    print(f"  diffusion 512^3 f32: 5 steps, launches by depth {by_depth}, "
          f"{1e3 * wall / 5:.2f} ms/step (host clock)")
    base = {5: out}
    base.update({n: simulate(prob, f0, n, strategy="swc", device=dev)
                 for n in (6, 7)})
    del out
    for strategy, depth, n, want in (
        ("swc", 2, 6, {2: 3}), ("swc", 3, 6, {3: 2}),
        ("swc", 3, 7, {3: 2, 1: 1}),
        ("swc_stream", 1, 5, {1: 5}), ("swc_stream", 2, 6, {2: 3}),
        ("swc_stream", 3, 6, {3: 2}), ("swc_stream", 3, 7, {3: 2, 1: 1}),
    ):
        stream = strategy == "swc_stream"
        out, wall, by_depth = counted(
            lambda: simulate(prob, f0, n, strategy=strategy,
                             fuse_steps=depth, device=dev),
            kernel=STREAM if stream else None)
        if by_depth != want:
            raise AssertionError(
                f"diffusion {strategy} fuse_steps={depth}, {n} steps: "
                f"launches {by_depth}, want {want}")
        if n != 7:
            key = "stream select" if stream else "select"
            launches[f"{key} S={depth}"] = by_depth[depth]
        _, rel = rel_err(out, base[n])
        print(f"  diffusion 512^3 f32 {strategy} fuse_steps={depth}: {n} "
              f"steps, launches by depth {by_depth}, "
              f"{1e3 * wall / n:.2f} ms/step (host clock); vs swc depth 1 "
              f"rel {rel:.3e}")
        if rel > 1e-5 or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{strategy} diffusion at depth {depth} "
                                 "disagrees with swc depth 1")
    del base, out, f0

    prob = DiffusionProblem((8192, 8192))
    f0 = prob.init_field(seed=0, device=dev)
    want = simulate(prob, f0, 5, strategy="swc", device=dev)
    out, wall, by_depth = counted(
        lambda: simulate(prob, f0, 5, strategy="swc_stream", device=dev),
        kernel=STREAM)
    if by_depth != {1: 5}:
        raise AssertionError(f"diffusion 8192^2 stream: launches {by_depth}")
    launches["stream select 8192^2"] = by_depth[1]
    _, rel = rel_err(out, want)
    print(f"  diffusion 8192^2 f32 swc_stream (y-stream): 5 steps, "
          f"launches by depth {by_depth}, {1e3 * wall / 5:.2f} ms/step "
          f"(host clock); vs swc rel {rel:.3e}")
    if rel > 1e-5 or not bool(torch.isfinite(out).all()):
        raise AssertionError("y-stream diffusion disagrees with swc")
    del want, out, f0

    prob = DiffusionProblem((64, 64, 64), safety=0.05)
    k, n = (1, 1, 2), 60
    f0 = prob.fourier_mode(k, device=dev)
    out = simulate(prob, f0, n, strategy="swc", device=dev)
    decay = float(out.norm() / f0.norm())
    spec = prob.merged_stencil()
    lam = sum(
        c * math.cos(
            sum(ki * oi * hi for ki, oi, hi in zip(k, o, prob.spacing)))
        for o, c in zip(spec.offsets, spec.coeffs)
    )
    ana = prob.analytic_decay(k, n * prob.dt)
    print(f"  Fourier mode f64 64^3: decay {decay:.12f}, exact discrete "
          f"{lam ** n:.12f}, analytic {ana:.12f}")
    if abs(decay - lam ** n) > 1e-10 or abs(decay - ana) / ana > 2e-3:
        raise AssertionError("Fourier-mode decay off")
    return launches


def phase_main_path_tc(dev, launches):
    """The tensor-core regime (``strategy="tc"``) and bf16 through the
    entry points: MHD in three RK3 forms, diffusion at depth 1 and 2, in
    bf16 (and bf16 on ``swc``: B1b), and at ranks 2 and 1, each held to
    its ``swc`` counterpart."""
    import torch

    from repro_torch.physics.diffusion import DiffusionProblem, simulate
    from repro_torch.physics.mhd import MHDSolver

    print("== phase 3 (tc): the tensor-core regime and bf16 on the main path")
    n_steps = 3
    for kind, n, form, want in (
        ("tc mhd_substep", 256, dict(fuse_rk_axpy=True), {1: 3 * n_steps}),
        ("tc mhd_rhs", 256, {}, {1: 3 * n_steps}),
        ("tc mhd pair", 128, dict(fuse_rk_pairs=True),
         {2: n_steps, 1: n_steps}),
    ):
        solver = MHDSolver((n,) * 3, strategy="tc", device=dev, **form)
        swc = MHDSolver((n,) * 3, strategy="swc", device=dev, **form)
        f0 = solver.init_fields(seed=0, dtype="float32")
        dt = float(solver.cfl_dt(f0))
        solver.step(f0, dt)  # warm-up

        def run(solver=solver):
            f = f0
            for _ in range(n_steps):
                f = solver.step(f, dt)
            return f

        f, wall, by_depth = counted(run, kernel=TC)
        if by_depth != want:
            raise AssertionError(f"{kind}: launches {by_depth}, want {want}")
        if f.shape != (8, n, n, n) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{kind}: bad MHD state")
        _, rel = rel_err(f, run(swc))
        launches[kind] = by_depth.get(2, by_depth[1])
        print(f"  MHD {n}^3 f32 RK3 on tc {form or 'plain'}: {n_steps} steps, "
              f"launches by depth {by_depth} (all {TC}), "
              f"{1e3 * wall / n_steps:.2f} ms/step (host clock); vs swc "
              f"rel {rel:.3e}")
        if rel > 1e-5:
            raise AssertionError(f"{kind}: tc and swc disagree")
        del f, solver, swc
        torch.cuda.empty_cache()

    for shape, cases in (
        ((512,) * 3, (("tc", 1, 5, "float32", "tc select S=1"),
                      ("tc", 2, 6, "float32", "tc select S=2"),
                      ("tc", 1, 5, "bfloat16", "tc select bf16"),
                      ("swc", 1, 5, "bfloat16", "select bf16"))),
        ((8192, 8192), (("tc", 1, 5, "float32", "tc select 8192^2"),)),
        ((1 << 26,), (("tc", 1, 5, "float32", "tc select 2^26"),)),
    ):
        prob = DiffusionProblem(shape)
        f0 = prob.init_field(seed=0, device=dev)
        base = {}
        for n in sorted({c[2] for c in cases}):
            # The swc run each case is held to: B1 on the main path too,
            # one fused_stencil launch per step.
            base[n], wall, by_depth = counted(
                lambda: simulate(prob, f0, n, strategy="swc", device=dev),
                kernel="fused_stencil")
            if by_depth != {1: n} or not bool(torch.isfinite(base[n]).all()):
                raise AssertionError(f"diffusion {shape} swc: launches "
                                     f"{by_depth}, want {n}, or bad state")
            if len(shape) < 3:
                key = f"select {'8192^2' if len(shape) == 2 else '2^26'}"
                launches[key] = by_depth[1]
                print(f"  diffusion {'x'.join(map(str, shape))} float32 swc: "
                      f"{n} steps, launches by depth {by_depth} (all "
                      f"fused_stencil), {1e3 * wall / n:.2f} ms/step (host "
                      "clock)")
        for strategy, depth, n, dtype, key in cases:
            kernel = TC if strategy == "tc" else "fused_stencil"
            fd = f0.to(getattr(torch, dtype))
            out, wall, by_depth = counted(
                lambda: simulate(prob, fd, n, strategy=strategy,
                                 fuse_steps=depth, device=dev),
                kernel=kernel)
            if by_depth != {depth: n // depth}:
                raise AssertionError(f"diffusion {shape} {strategy} {dtype} "
                                     f"S={depth}: launches {by_depth}")
            if out.dtype != fd.dtype or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"diffusion {shape} {key}: bad state")
            launches[key] = by_depth[depth]
            _, rel = rel_err(out, base[n])
            # bf16 on swc rounds every tap in bf16 (the reference's VPU
            # path), so its n steps are held to the plain bf16 version;
            # tc accumulates in f32 and is held to f32, as the
            # reference's tests/test_tc.py holds it.
            versus = ("swc f32 depth 1", rel)
            if strategy == "swc":
                plain_out = simulate(prob, fd, n, strategy="hwc", device=dev)
                versus = ("the plain bf16 version", rel_err(out, plain_out)[1])
                del plain_out
            print(f"  diffusion {'x'.join(map(str, shape))} {dtype} "
                  f"{strategy} fuse_steps={depth}: {n} steps, launches by "
                  f"depth {by_depth} (all {kernel}), {1e3 * wall / n:.2f} "
                  f"ms/step (host clock); vs swc f32 depth 1 rel {rel:.3e}"
                  + (f", vs {versus[0]} rel {versus[1]:.3e}"
                     if strategy == "swc" else ""))
            if versus[1] > TOL[dtype]:
                raise AssertionError(f"diffusion {key} disagrees with "
                                     f"{versus[0]}")
            del out, fd
        del base, f0
        torch.cuda.empty_cache()


def phase_main_path_1d(dev, launches):
    """The 1-D path: ``step_1d_xcorr`` at 2^26, f32, 5 steps on each B6
    strategy, every step one ``xcorr1d`` launch (the counters zeroed just
    before and read just after), held to B1's ``simulate(..., "swc")``."""
    import torch

    from repro_torch.kernels import emit
    from repro_torch.kernels import xcorr1d as kx
    from repro_torch.physics.diffusion import (
        DiffusionProblem,
        simulate,
        step_1d_xcorr,
    )

    print("== phase 3 (1-D): step_1d_xcorr at 2^26 on B6 (csrc/xcorr1d.cu)")
    n_steps = 5
    prob = DiffusionProblem((1 << 26,), accuracy=6)
    f0 = prob.init_field(seed=0, device=dev)[0]
    want = simulate(prob, f0[None], n_steps, strategy="swc", device=dev)[0]
    for strategy, _ in XCORR_STRATEGIES:
        step_1d_xcorr(f0, prob, strategy=strategy)  # warm-up

        def run(strategy=strategy):
            f = f0
            for _ in range(n_steps):
                f = step_1d_xcorr(f, prob, strategy=strategy)
            return f

        torch.cuda.synchronize()
        kx.reset_launch_counts()
        emit.reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by = dict(kx.xcorr1d_cuda.launches_by_strategy)
        if by != {strategy: n_steps} or kx.xcorr1d_cuda.launches != n_steps \
                or emit.fused_stencil_swc.launches:
            raise AssertionError(
                f"step_1d_xcorr {strategy}: launches {by}, "
                f"{emit.fused_stencil_swc.launches} fused-stencil launches; "
                f"want {n_steps} xcorr1d")
        if out.shape != f0.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"step_1d_xcorr {strategy}: bad state")
        launches[f"xcorr {strategy}"] = by[strategy]
        _, rel = rel_err(out, want)
        print(f"  diffusion 2^26 f32 order 6 step_1d_xcorr {strategy}: "
              f"{n_steps} steps, launches {by}, "
              f"{1e3 * wall / n_steps:.4f} ms/step (host clock); vs swc "
              f"(B1) rel {rel:.3e}")
        if rel > TOL["float32"]:
            raise AssertionError(f"step_1d_xcorr {strategy} disagrees with "
                                 "swc")
        del out
    del want, f0
    torch.cuda.empty_cache()


def _reset_all_counts():
    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import emit
    from repro_torch.kernels import xcorr1d as kx

    emit.reset_launch_counts()
    kx.reset_launch_counts()
    kc.reset_launch_counts()


def _all_counts() -> tuple[int, int, int]:
    """(B7, fused-stencil, xcorr1d) launches since the last reset."""
    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import emit
    from repro_torch.kernels import xcorr1d as kx

    return (kc.conv1d_depthwise_cuda.launches,
            emit.fused_stencil_swc.launches, kx.xcorr1d_cuda.launches)


def phase_main_path_ssm(dev, smi, launches):
    """mamba2-780m at full width (48 layers, d_model 1536, state 128,
    vocab 50280), random init from a seeded generator on the card,
    through ``repro_torch.launch.steps`` and ``launch.serve``: the
    prefill (4, 8192) in bf16 with 48 B7 launches (counters zeroed just
    before, read just after) held to the same prefill with the plain conv;
    forward (with B7) against step-by-step decode in f32 on (2, 512); the
    serve loop at batch 4, 32 steps."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import ssm

    print("== phase 3 (mamba2): mamba2-780m prefill and decode on B7 "
          "(csrc/conv1d_depthwise.cu)")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in f32
    cfg = get_config("mamba2-780m")
    params = ssm.init_params(cfg, seed=0, device=dev)
    n_par = sum(v.numel() for t in (params, params["blocks"])
                for v in t.values() if torch.is_tensor(v))
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"conv channels {cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state}"
          f", {n_par} parameters (config: {cfg.n_params():.0f}), {cfg.dtype}")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s = PREFILL_SHAPE
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    prefill = make_prefill_step(cfg, device=dev)
    plain_prefill = make_prefill_step(cfg, device=dev, use_pallas_conv=False)
    batch = {"tokens": tokens}
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_all_counts()
        out = prefill(params, batch)
        torch.cuda.synchronize()
        conv_n, stencil_n, xcorr_n = _all_counts()
        if (conv_n, stencil_n, xcorr_n) != (cfg.n_layers, 0, 0):
            raise AssertionError(
                f"prefill: {conv_n} B7, {stencil_n} fused-stencil and "
                f"{xcorr_n} xcorr1d launches; want {cfg.n_layers}, 0, 0")
        launches["conv1d prefill"] = conv_n
        if out.shape != (b, cfg.vocab) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"prefill: bad logits {tuple(out.shape)}")
        _reset_all_counts()
        want = plain_prefill(params, batch)
        if _all_counts() != (0, 0, 0):
            raise AssertionError("the plain-conv prefill launched a kernel")
        err, rel = rel_err(out, want)
        print(f"  prefill {PREFILL_SHAPE} {cfg.dtype}: launches B7 {conv_n}, "
              f"fused-stencil {stencil_n}, xcorr1d {xcorr_n}; last logits vs "
              f"use_pallas_conv=False max|err| {err:.3e} rel {rel:.3e} "
              f"(tol {TOL['bfloat16']:.0e}) "
              f"{'ok' if rel <= TOL['bfloat16'] else 'FAIL'}")
        if rel > TOL["bfloat16"]:
            raise AssertionError(f"prefill: rel err {rel:.3e} vs plain conv")
        del out, want
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        prefill_ms = statistics.median(times)
        print(f"  prefill {PREFILL_SHAPE} {cfg.dtype}: {prefill_ms:.1f} ms "
              f"(host clock, median of {len(times)} after the "
              f"warm-up; {b * s / prefill_ms * 1e3:.0f} tokens/s) on {smi}")
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del tokens, batch

        # Decode consistency (tests/test_system.py:67) at full width, f32.
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        b2, s2 = DECODE_SHAPE
        toks = torch.randint(0, cfg.vocab, (b2, s2), generator=gen,
                             device=dev)
        _reset_all_counts()
        full, _ = ssm.forward(params, cfg32, toks)
        torch.cuda.synchronize()
        counts = _all_counts()
        if counts != (cfg.n_layers, 0, 0):
            raise AssertionError(f"f32 forward: launches {counts}")
        launches["conv1d f32 forward"] = counts[0]
        step = make_serve_step(cfg32, device=dev)
        cache = ssm.init_decode_cache(cfg32, b2, s2, device=dev)
        errs = torch.empty(s2, device=dev)
        for t in range(s2):
            lg, cache = step(params, cache, {"tokens": toks[:, t:t + 1]})
            errs[t] = (lg - full[:, t]).abs().max()
        worst = float(errs.max())
        rel = worst / float(full.abs().max())
        print(f"  decode vs forward (B7) {DECODE_SHAPE} f32, {s2} steps from "
              f"an empty cache: max|err| {worst:.3e} (tol {DECODE_TOL:.1e}; "
              f"rel {rel:.3e}; worst step {int(errs.argmax())}) "
              f"{'ok' if worst <= DECODE_TOL else 'FAIL'}")
        if not worst <= DECODE_TOL:
            raise AssertionError(f"decode vs forward: max|err| {worst:.3e}")
        del full, cache, toks, errs

    # The serve loop of launch/serve.py, after a two-step warm-up.
    serve(cfg, batch=LM_BATCH, steps=2, device=dev, params=params)
    gen_tokens, secs = serve(cfg, batch=LM_BATCH, steps=LM_STEPS,
                             device=dev, params=params)
    if gen_tokens.shape != (LM_BATCH, LM_STEPS + 1) or \
            int(gen_tokens.min()) < 0 or int(gen_tokens.max()) >= cfg.vocab:
        raise AssertionError(f"serve: bad tokens {tuple(gen_tokens.shape)}")
    print(f"  serve batch {LM_BATCH}, {LM_STEPS} steps {cfg.dtype}: "
          f"{LM_BATCH * LM_STEPS / secs:.1f} tokens/s, "
          f"{1e3 * secs / LM_STEPS:.2f} ms per decode step (host clock) "
          f"on {smi}")
    print("  first row: " + " ".join(map(str, gen_tokens[0, :12].tolist())))
    del params
    torch.cuda.empty_cache()


SERVE_SHAPES = [(256, 256, 256), (4096, 4096)]
SERVE_REQUESTS, SERVE_STEPS, SERVE_BATCH = 16, 8, 8


def phase_serve(dev, launches):
    """Ensemble serving through ``SimServer`` on each CUDA strategy: a
    warm-up queue of the same size (so the allocator holds full-batch
    blocks), then the 16-request queue with the launch counters zeroed
    just before and read just after, per batch."""
    import collections

    import torch

    from repro_torch.kernels import emit
    from repro_torch.launch.serve_sim import SimServer, check_parity, demo_queue

    print("== phase 3b: ensemble serving (SimServer at its defaults, f32)")
    for strategy, kernel in (("swc", "fused_stencil"), ("swc_stream", STREAM),
                             ("tc", TC)):
        server = SimServer(strategy=strategy, max_batch=SERVE_BATCH,
                           device=dev)
        server.serve(demo_queue(SERVE_SHAPES, SERVE_STEPS, SERVE_REQUESTS,
                                seed=1, device=dev))  # warm-up
        queue = demo_queue(SERVE_SHAPES, SERVE_STEPS, SERVE_REQUESTS,
                           device=dev)
        by_id = {r.req_id: r for r in queue.snapshot()}
        warm = len(server.reports)
        marks = []  # per-kernel launch counts at each batch's start
        server.batch_hook = lambda index, reqs: marks.append(
            collections.Counter(emit.fused_stencil_swc.launches_by_kernel))
        server.request_status.clear()
        torch.cuda.synchronize()
        emit.reset_launch_counts()
        t0 = time.perf_counter()
        results = server.serve(queue)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        marks.append(collections.Counter(
            emit.fused_stencil_swc.launches_by_kernel))
        reports = server.reports[warm:]
        statuses = {rid: server.request_status.get(rid) for rid in by_id}
        if set(statuses.values()) != {"ok"} or server.error_reports:
            raise AssertionError(f"serve {strategy}: statuses {statuses}, "
                                 f"errors {server.error_reports}")
        if [r.strategy for r in reports] != [strategy] * len(reports):
            raise AssertionError(f"serve {strategy}: batches ran "
                                 f"{[r.strategy for r in reports]}")
        per_batch = [dict(b - a) for a, b in zip(marks, marks[1:])]
        if len(reports) != SERVE_REQUESTS // SERVE_BATCH or per_batch != [
            {kernel: SERVE_STEPS}
        ] * len(reports):
            raise AssertionError(f"serve {strategy}: launches per batch "
                                 f"{per_batch} in {len(reports)} batches")
        err = check_parity(server, by_id, results)
        for r, n in zip(reports, per_batch):  # per bucket: its timed row
            key = f"serve {strategy} {'x'.join(map(str, r.key[0]))}"
            launches[key] = launches.get(key, 0) + sum(n.values())
        member_steps = sum(r.batch for r in reports) * SERVE_STEPS
        print(f"  {strategy}: {len(results)}/{SERVE_REQUESTS} requests ok in "
              f"{len(reports)} batches of {SERVE_BATCH} "
              f"({', '.join('x'.join(map(str, r.key[0])) for r in reports)}), "
              f"{wall:.4f} s, {member_steps / wall:.1f} member-steps/s "
              "(host clock)")
        for r, n in zip(reports, per_batch):
            print(f"    batch {'x'.join(map(str, r.key[0]))}: "
                  f"{r.seconds:.6f} s, "
                  f"{r.seconds / (r.batch * SERVE_STEPS) * 1e3:.4f} ms per "
                  f"member-step, launches {n}")
        print(f"    vs per-member plain version on the card: max|err| "
              f"{err:.3e} (tol 1e-5 of each bucket's largest |value|)")
        del server, results, queue, by_id
        torch.cuda.empty_cache()


def phase_times(dev, smi, launches):
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.core.trafficmodel import (
        stencil_hbm_bytes_per_step,
        stencil_redundant_compute_fraction,
        stencil_stream_hbm_bytes_per_step,
    )
    from repro_torch.kernels.emit import fused_stencil_swc
    from repro_torch.kernels.phi import phi_sequence
    from repro_torch.kernels.plan import _stream_segments, tc_issued_macs
    from repro_torch.physics import mhd

    print("== phase 4: times (CUDA events, median)")
    name = torch.cuda.get_device_name(0)
    bw, f32_rate, f64_rate = card_rates(name)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []

    def row(label, kind, case, dtype, phi_flops, library=None, reps=10,
            plain_reps=3, main=None):
        """Time one launch; ``main`` names its main-path launch count
        and puts the row in the kernels line."""
        fp, ops, phi, plan, aux = case
        depth = plan.fuse_steps
        item = fp.element_size()
        batch = plan.batch if fp.ndim == plan.rank + 2 else 0
        got = fused_stencil_swc(fp, ops, phi, plan, aux=aux)
        want = plain(case)
        err, rel = rel_err(got, want)
        if rel > TOL[dtype]:
            raise AssertionError(f"{label}: rel err {rel:.3e}")
        del want
        ms = time_ms(lambda: fused_stencil_swc(fp, ops, phi, plan, aux=aux),
                     reps)
        if batch:  # the same members, one unbatched launch each, cut
            # into the stream segments the planner gives one member
            solo = dataclasses.replace(plan, batch=1)
            if plan.stream_axis is not None:
                solo = dataclasses.replace(solo, segments=_stream_segments(
                    plan.block, plan.interior, plan.radii, depth))
            members = [(fp[m], None if aux is None else aux[m])
                       for m in range(batch)]
            solo_ms = time_ms(lambda: [
                fused_stencil_swc(f, ops, phi, solo, aux=a) for f, a in members
            ], reps)
        plain_ms = time_ms(lambda: plain(case), plain_reps, warmup=1)
        lib_ms = None
        if library is not None:
            t = time.perf_counter()
            lib_out = library()
            torch.cuda.synchronize()
            slow = time.perf_counter() - t > 0.05  # e.g. conv3d at 512^3
            lerr, _ = rel_err(lib_out.reshape(got.shape), got)
            del lib_out
            # A library call of tens of ms or more is timed over 3 calls
            # after one warm-up, which keeps the run within its budget.
            lib_ms = time_ms(library, 3 if slow else reps,
                             warmup=1 if slow else 2)
            print(f"    library conv vs kernel max|err| {lerr:.3e}")
        points = max(batch, 1)
        for n_ in plan.interior:
            points *= n_
        nbytes = (fp.numel() + got.numel()
                  + (0 if aux is None else aux.numel())) * item
        flops = depth * (ops.flops_per_point(plan.n_f) + phi_flops) * points
        t_bytes = nbytes / bw * 1e3
        tc = plan.strategy == "tc"
        if tc:  # the tensor-core route's rate (bf16 MMA, or f64 MMA)
            rate = TC_RATES[dtype]
        else:  # outside the tensor cores; bf16 counted at the f32 rate
            rate = f64_rate if item == 8 else f32_rate
        t_ops = flops / rate * 1e3
        bound = max(t_bytes, t_ops)
        stream = plan.stream_axis is not None
        if tc:
            issued, needed = tc_issued_macs(plan, ops, phi_sequence(
                phi, depth)[0].operators)
            name_, source, replaces = (f"{TC}[{kind}, S={depth}, {dtype}",
                                       TC_SOURCE, TC_REPLACES)
            print(f"    tc: tile {plan.block}, {plan.smem_bytes} B shared; "
                  f"{tc_launch_info(plan, phi_sequence(phi, depth)[0])}; "
                  f"banded MACs issued {issued:.6e} against "
                  f"{needed:.6e} for the multi-tap groups' taps "
                  f"({issued / needed:.3f}x)")
        elif stream:
            name_, source, replaces = (f"{STREAM}[{kind}, S={depth}",
                                       STREAM_SOURCE, STREAM_REPLACES)
            if depth == 1:
                print(f"    stream: {stream_launch_info(plan, phi)}")
        elif depth == 1:
            name_, source, replaces = (f"fused_stencil_swc[{kind}",
                                       KERNEL_SOURCE, REPLACES)
            if item == 2:
                name_ += ", bf16"
            print(f"    swc: tile {plan.block}, {plan.smem_bytes} B shared; "
                  f"{swc_launch_info(plan, phi)}")
        else:
            name_, source, replaces = (
                f"fused_stencil_temporal[{kind}, S={depth}",
                TEMPORAL_SOURCE, TEMPORAL_REPLACES)
        if batch:
            name_, replaces = f"{name_}, B={batch}]", BATCH_REPLACES
        else:
            name_ += "]"
        r = {
            "name": name_,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[main] if main else 0,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        }
        print(f"  {label:<34} {dtype:<7} kernel {ms:9.4f} ms  plain "
              f"{plain_ms:10.4f} ms  bound {bound:8.4f} ms "
              f"({r['bound_by']})  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
              f"max|err| {err:.3e}  {bound / ms:.1%} of bound")
        if batch:
            print(f"    {batch} members in one launch (grid z {plan.grid_z}, "
                  f"{plan.segments} segment(s)): {ms:.4f} ms; {batch} "
                  f"unbatched launches ({solo.segments} segment(s) each): "
                  f"{solo_ms:.4f} ms ({ms / batch:.4f} against "
                  f"{solo_ms / batch:.4f} ms per member)")
        elif stream and not tc:
            model = dict(domain=plan.interior, block=plan.block,
                         radii=plan.radii, n_f=plan.n_f, n_out=plan.n_out,
                         itemsize=item, fuse_steps=depth)
            walk = stencil_stream_hbm_bytes_per_step(
                **model, segments=plan.segments)
            one = stencil_stream_hbm_bytes_per_step(**model)
            swc = stencil_hbm_bytes_per_step(**model)
            redundant = stencil_redundant_compute_fraction(
                plan.block, plan.radii, depth)
            print(f"    stream S={depth}: {ms / depth:.4f} ms per step; "
                  f"chunk and cross tile {plan.block}, {plan.segments} "
                  f"segment(s), {plan.threads} threads, {plan.smem_bytes} B "
                  f"shared; modelled {walk:.6e} B/step (one walk "
                  f"{one:.6e}; swc at this tile {swc:.6e}), redundant work "
                  f"{redundant:.4f}")
        elif depth > 1 and not tc:
            traffic = [
                stencil_hbm_bytes_per_step(
                    plan.interior, plan.block, plan.radii, plan.n_f,
                    plan.n_out, item, s)
                for s in (depth, 1)
            ]
            redundant = stencil_redundant_compute_fraction(
                plan.block, plan.radii, depth)
            print(f"    S={depth}: {ms / depth:.4f} ms per step; tile "
                  f"{plan.block}, {plan.threads} threads, "
                  f"{plan.smem_bytes} B shared, "
                  f"{plan.stage_buffers} window buffer(s); modelled "
                  f"{traffic[0]:.6e} B/step (depth 1: {traffic[1]:.6e}), "
                  f"redundant work {redundant:.4f}")
        if main:
            rows.append(r)
        return r

    def conv_of(case):
        fp, ops, _, plan, _ = case
        spec = ops.ops[0]
        rad = ops.radius_per_axis()
        w = torch.zeros(tuple(2 * r + 1 for r in rad), dtype=torch.float64)
        for off, c in zip(spec.offsets, spec.coeffs):
            w[tuple(o + r for o, r in zip(off, rad))] = c
        w = w.to(device=fp.device, dtype=fp.dtype)[None, None]
        conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[plan.rank]
        x = fp if fp.ndim == plan.rank + 2 else fp[None]  # N = B

        def run():  # one valid convolution per fused step
            y = x
            for _ in range(plan.fuse_steps):
                y = conv(y, w)
            return y

        return run

    print(f"  card: {smi}")
    case = diffusion_case((512,) * 3, "float32", dev)
    row("diffusion 512^3", "select", case, "float32", 0, conv_of(case),
        main="select")
    del case
    for depth in (2, 3):
        case = diffusion_case((512,) * 3, "float32", dev, fuse_steps=depth)
        row(f"diffusion 512^3 S={depth} (library: {depth} convs)", "select",
            case, "float32", 0, conv_of(case), main=f"select S={depth}")
        del case
        case = diffusion_case((256,) * 3, "float64", dev, fuse_steps=depth)
        row(f"diffusion 256^3 S={depth} (library: {depth} convs)", "select",
            case, "float64", 0, conv_of(case))
        del case
    for shape, key in (((1 << 26,), "select 2^26"),
                       ((8192, 8192), "select 8192^2")):
        case = diffusion_case(shape, "float32", dev)
        row(f"diffusion {shape}", key, case, "float32", 0, conv_of(case),
            main=key)
        del case
    case = diffusion_case((256,) * 3, "float64", dev)
    row("diffusion 256^3", "select", case, "float64", 0, conv_of(case))
    del case
    substep_ms = {}
    for substep, kind, flops in (
        (True, "mhd_substep", mhd.SUBSTEP_PHI_FLOPS),
        (False, "mhd_rhs", mhd.RHS_PHI_FLOPS),
    ):
        case = mhd_case((256,) * 3, "float32", dev, substep, smooth=False)
        substep_ms[kind] = row(f"MHD {kind} 256^3", kind, case, "float32",
                               flops, main=kind, reps=5, plain_reps=2)["ms"]
        del case
        case = mhd_case((128,) * 3, "float64", dev, substep, smooth=False)
        row(f"MHD {kind} 128^3", kind, case, "float64", flops, reps=5,
            plain_reps=2)
        del case
        torch.cuda.empty_cache()
    for shape, dtype, main in (((256,) * 3, "float32", "mhd pair"),
                               ((128,) * 3, "float64", None)):
        case = mhd_pair_case(shape, dtype, dev, substeps=(0, 1),
                             smooth=False)
        r = row(f"MHD pair {shape[0]}^3", "mhd_substep", case, dtype,
                mhd.SUBSTEP_PHI_FLOPS, main=main, reps=3, plain_reps=1)
        if main:
            print(f"    RK3 step with fuse_rk_pairs: pair {r['ms']:.4f} + "
                  f"substep {substep_ms['mhd_substep']:.4f} = "
                  f"{r['ms'] + substep_ms['mhd_substep']:.4f} ms of kernel; "
                  f"fused axpy: 3 x {substep_ms['mhd_substep']:.4f} = "
                  f"{3 * substep_ms['mhd_substep']:.4f} ms")
        del case
        torch.cuda.empty_cache()

    print("  -- stream kernel (swc_stream)")
    for depth in (1, 2, 3):
        case = diffusion_case((512,) * 3, "float32", dev, fuse_steps=depth,
                              strategy="swc_stream")
        row(f"stream diffusion 512^3 S={depth}", "select", case, "float32",
            0, conv_of(case), main=f"stream select S={depth}")
        del case
    case = diffusion_case((8192, 8192), "float32", dev, strategy="swc_stream")
    row("stream diffusion (8192, 8192)", "select y-stream", case, "float32",
        0, conv_of(case), main="stream select 8192^2")
    del case
    case = diffusion_case((256,) * 3, "float64", dev, strategy="swc_stream")
    row("stream diffusion 256^3", "select", case, "float64", 0,
        conv_of(case))
    del case
    case = mhd_case((256,) * 3, "float32", dev, False, smooth=False,
                    strategy="swc_stream")
    row("stream MHD mhd_rhs 256^3", "mhd_rhs", case, "float32",
        mhd.RHS_PHI_FLOPS, main="stream mhd_rhs", reps=5, plain_reps=2)
    del case
    case = mhd_case((128,) * 3, "float64", dev, False, smooth=False,
                    strategy="swc_stream")
    row("stream MHD mhd_rhs 128^3", "mhd_rhs", case, "float64",
        mhd.RHS_PHI_FLOPS, reps=5, plain_reps=2)
    del case
    torch.cuda.empty_cache()

    print("  -- ensemble batch (B5): B members in one launch")
    for label, kw in (("B1", dict()), ("B3 S=1", dict(strategy="swc_stream")),
                      ("B2 S=2", dict(fuse_steps=2))):
        case = diffusion_case((256,) * 3, "float32", dev, batch=8, **kw)
        row(f"diffusion 256^3 B=8, {label}", "select", case, "float32", 0,
            conv_of(case))
        del case
    # The serve phase's own launches: order 2 (its default), one bucket
    # each, with that bucket's launch count from phase 3b.
    for strategy in ("swc", "swc_stream"):
        for shape in SERVE_SHAPES:
            bucket = "x".join(map(str, shape))
            case = diffusion_case(shape, "float32", dev, batch=SERVE_BATCH,
                                  accuracy=2, strategy=strategy)
            row(f"serve {bucket} B={SERVE_BATCH}, {strategy}",
                f"serve {bucket}", case, "float32", 0, conv_of(case),
                main=f"serve {strategy} {bucket}")
            del case
        torch.cuda.empty_cache()
    case = mhd_case((128,) * 3, "float32", dev, False, smooth=False, batch=4)
    row("MHD mhd_rhs 128^3 B=4, B1", "mhd_rhs", case, "float32",
        mhd.RHS_PHI_FLOPS, reps=5, plain_reps=2)
    del case
    torch.cuda.empty_cache()

    print("  -- tc kernel (tensor cores) and bf16 in B1 (B1b)")
    for shape, depth, dtype, strategy, main in (
        ((512,) * 3, 1, "float32", "tc", "tc select S=1"),
        ((512,) * 3, 2, "float32", "tc", "tc select S=2"),
        ((512,) * 3, 1, "bfloat16", "tc", "tc select bf16"),
        ((512,) * 3, 1, "bfloat16", "swc", "select bf16"),
        ((8192, 8192), 1, "float32", "tc", "tc select 8192^2"),
        ((1 << 26,), 1, "float32", "tc", "tc select 2^26"),
    ):
        case = diffusion_case(shape, dtype, dev, fuse_steps=depth,
                              strategy=strategy)
        kind = "select" if len(shape) == 3 else (
            f"select {'x'.join(map(str, shape))}")
        row(f"{strategy} diffusion {shape} S={depth}", kind, case, dtype,
            0, conv_of(case), main=main)
        del case
    torch.cuda.empty_cache()
    for substep, kind, flops in (
        (True, "mhd_substep", mhd.SUBSTEP_PHI_FLOPS),
        (False, "mhd_rhs", mhd.RHS_PHI_FLOPS),
    ):
        case = mhd_case((256,) * 3, "float32", dev, substep, smooth=False,
                        strategy="tc")
        row(f"tc MHD {kind} 256^3", kind, case, "float32", flops,
            main=f"tc {kind}", reps=5, plain_reps=2)
        del case
        torch.cuda.empty_cache()
    case = mhd_pair_case((128,) * 3, "float32", dev, substeps=(0, 1),
                         smooth=False, strategy="tc")
    row("tc MHD pair 128^3", "mhd_substep", case, "float32",
        mhd.SUBSTEP_PHI_FLOPS, main="tc mhd pair", reps=3, plain_reps=1)
    del case
    for shape in SERVE_SHAPES:
        bucket = "x".join(map(str, shape))
        case = diffusion_case(shape, "float32", dev, batch=SERVE_BATCH,
                              accuracy=2, strategy="tc")
        row(f"serve {bucket} B={SERVE_BATCH}, tc", f"serve {bucket}", case,
            "float32", 0, conv_of(case), main=f"serve tc {bucket}")
        del case
    torch.cuda.empty_cache()
    return rows


def phase_times_xcorr(dev, smi, launches):
    """B6 rows (CUDA events, median): n = 2^24, fig07's full size
    (``benchmarks/fig07_xcorr_library.py``), f32 at radii 1-1024 and f64
    at r = 1 and 1024 (the paper's Table 3 cases), each strategy at
    unroll 4; then the 2^26 ``step_1d_xcorr`` launch of each strategy,
    whose rows go to the kernels line. The library call is
    ``F.conv1d(f[None, None], g[None, None])`` (cuDNN, the paper's Fig. 7)
    timed with ``torch.backends.cudnn.allow_tf32 = False``; the flag is
    restored after. The port never calls it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.stencil import diffusion_kernel_1d
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.physics.diffusion import DiffusionProblem

    print("== phase 4 (1-D): B6 xcorr1d times (CUDA events, median)")
    print(f"  card: {smi}")
    name = torch.cuda.get_device_name(0)
    bw, f32_rate, f64_rate = card_rates(name)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    rows = []

    def rows_for(label, f, g, dtype, main=None, reps=10):
        """One row per strategy on the inputs (f, g); the plain and the
        library call are timed once for the three."""
        n_taps = g.shape[0]
        n = f.shape[0] - n_taps + 1
        item = f.element_size()
        want = ref.xcorr1d(f, g)
        plain_ms = time_ms(lambda: ref.xcorr1d(f, g), 2, warmup=1)
        x, w = f[None, None], g[None, None]
        t = time.perf_counter()
        lib_out = F.conv1d(x, w)[0, 0]
        torch.cuda.synchronize()
        slow = time.perf_counter() - t > 0.05
        _, lib_rel = rel_err(lib_out, want)
        del lib_out
        lib_ms = time_ms(lambda: F.conv1d(x, w), 3 if slow else reps,
                         warmup=1 if slow else 2)
        t_bytes = (f.numel() + n_taps + n) * item / bw * 1e3
        t_ops = 2 * n_taps * n / (f64_rate if item == 8 else f32_rate) * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        for strategy, unroll in XCORR_STRATEGIES:
            got = kops.xcorr1d(f, g, strategy=strategy, unroll=unroll)
            err, rel = rel_err(got, want)
            if rel > TOL[dtype]:
                raise AssertionError(f"{label} {strategy}: rel err {rel:.3e}")
            del got
            ms = time_ms(lambda: kops.xcorr1d(f, g, strategy=strategy,
                                              unroll=unroll), reps)
            r = {
                "name": f"xcorr1d[{strategy}, u{unroll}, {label}, {dtype}]",
                "route": "cuda",
                "source": XCORR_SOURCE,
                "replaces": XCORR_REPLACES,
                "launches": launches[f"{main} {strategy}"] if main else 0,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": lib_ms,
            }
            print(f"  {label:<22} {dtype:<7} {strategy:<11} kernel "
                  f"{ms:9.4f} ms  plain {plain_ms:10.4f} ms  bound "
                  f"{bound:7.4f} ms ({by})  conv1d (no TF32) {lib_ms:.4f} "
                  f"ms  max|err| {err:.3e}  {bound / ms:.1%} of bound")
            if main:
                rows.append(r)
        print(f"    conv1d vs plain rel {lib_rel:.3e}")
        del want

    try:
        n = 1 << 24
        for dtype, radii in (("float32", (1, 4, 16, 64, 256, 1024)),
                             ("float64", (1, 1024))):
            for r in radii:
                f, g = xcorr_inputs(n, r, dtype, dev, seed=r)
                rows_for(f"n=2^24 r={r}", f, g, dtype)
                del f, g
        prob = DiffusionProblem((1 << 26,), accuracy=6)
        f0 = prob.init_field(seed=0, device=dev)[0]
        r = prob.radius
        fp = torch.cat([f0[-r:], f0, f0[:r]])
        g = torch.as_tensor(
            diffusion_kernel_1d(prob.accuracy, prob.dt, prob.alpha,
                                prob.spacing[0]),
            dtype=fp.dtype, device=dev)
        rows_for("step_1d_xcorr 2^26 r=3", fp, g, "float32",
                 main="xcorr")
        del fp, f0
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return rows


def phase_times_conv1d(dev, smi, launches):
    """B7 rows (CUDA events, median) at mamba2-780m's prefill launch: the
    strided xBC view (4, 8192, 3328) of a (4, 8192, 6448) in-projection,
    k = 4, bf16 (the main path's dtype, 48 launches per prefill) and f32
    (the f32 forward's, also 48). Bound: bytes = ((b·(s+k-1) + k)·c +
    b·s·c) values (the padded input and the taps read once, the output
    written once) over the memory rate, against 2·k·b·s·c FLOPs at the
    non-tensor f32 rate. The library call is ``F.conv1d(groups=c,
    padding=k-1)`` (cuDNN, TF32 off) on a contiguous (b, c, s) copy; the
    copy's time is printed apart. The port never calls it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    print("== phase 4 (mamba2): B7 conv1d_depthwise times (CUDA events, "
          "median)")
    print(f"  card: {smi}")
    bw, f32_rate, _ = card_rates(torch.cuda.get_device_name(0))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    b, s = PREFILL_SHAPE
    c, k, row = 3328, 4, 6448
    rows = []
    try:
        for dtype, key in (("bfloat16", "conv1d prefill"),
                           ("float32", "conv1d f32 forward")):
            x, w = conv_inputs((b, s, c), k, dtype, dev, seed=11, row=row,
                               offset=3072)
            item = x.element_size()
            want = ref.conv1d_depthwise(x, w)
            got = kops.conv1d_depthwise(x, w)
            err, rel = rel_err(got, want)
            if rel > TOL[dtype]:
                raise AssertionError(f"conv1d {dtype}: rel err {rel:.3e}")
            del got
            ms = time_ms(lambda: kops.conv1d_depthwise(x, w), 20)
            xc = x.contiguous()
            ms_contig = time_ms(lambda: kops.conv1d_depthwise(xc, w), 20)
            del xc
            plain_ms = time_ms(lambda: ref.conv1d_depthwise(x, w), 5)
            copy_ms = time_ms(lambda: x.transpose(1, 2).contiguous(), 10)
            xt = x.transpose(1, 2).contiguous()  # (b, c, s)
            wt = w.t().contiguous()[:, None, :]  # (c, 1, k)
            lib = F.conv1d(xt, wt, padding=k - 1, groups=c)[..., :s]
            _, lib_rel = rel_err(lib.transpose(1, 2), want)
            del lib, want
            lib_ms = time_ms(
                lambda: F.conv1d(xt, wt, padding=k - 1, groups=c), 20)
            del xt
            values = (b * (s + k - 1) + k) * c + b * s * c
            t_bytes = values * item / bw * 1e3
            t_ops = 2 * k * b * s * c / f32_rate * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            rows.append({
                "name": f"conv1d_depthwise[mamba2 prefill xBC {b}x{s}x{c} "
                        f"k={k}, {dtype}]",
                "route": "cuda",
                "source": CONV_SOURCE,
                "replaces": CONV_REPLACES,
                "launches": launches[key],
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": lib_ms,
            })
            print(f"  xBC view {b}x{s}x{c} k={k} {dtype:<8} vec"
                  f"{kc.vector_width(x, w)}: kernel {ms:.4f} ms (contiguous "
                  f"input {ms_contig:.4f})  plain {plain_ms:.4f} ms  bound "
                  f"{bound:.4f} ms ({by}, {values * item / 1e6:.1f} MB)  "
                  f"conv1d (groups=c, no TF32) {lib_ms:.4f} ms + transpose "
                  f"copy {copy_ms:.4f} ms  max|err| {err:.3e}  "
                  f"{bound / ms:.1%} of bound  launches/prefill "
                  f"{launches[key]}; conv1d vs plain rel {lib_rel:.3e}")
            del x, w
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return rows


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch

    dev = repro_torch.default_device()
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        print(f"  [{name}: {seconds[name]:.1f} s]")
        return out

    smi = timed("phase 1", phase_card)
    print(smi)
    timed("phase 2", phase_parity, dev)
    if "--quick" in argv:
        return 0
    launches = timed("phase 3", phase_main_path, dev)
    timed("phase 3 (tc)", phase_main_path_tc, dev, launches)
    timed("phase 3 (1-D)", phase_main_path_1d, dev, launches)
    timed("phase 3 (mamba2)", phase_main_path_ssm, dev, smi, launches)
    timed("phase 3b", phase_serve, dev, launches)
    rows = timed("phase 4", phase_times, dev, smi, launches)
    rows += timed("phase 4 (1-D)", phase_times_xcorr, dev, smi, launches)
    rows += timed("phase 4 (mamba2)", phase_times_conv1d, dev, smi, launches)
    print("chip_smoke: seconds by phase "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(f"chip_smoke: all phases in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
