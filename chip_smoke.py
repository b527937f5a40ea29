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
   and a non-cubic box; the temporal kernel against
   ``ref.fused_stencil_steps`` — diffusion at depth 2 and 3, ranks 1-3,
   two selected fields, and the MHD pair (two RK3 substep φs, aux w).
3. Main path at full size, through the entry points a user calls, with
   the launch counters (total and per depth) zeroed just before and
   read just after each run: MHD 256³ f32 RK3 with the fused axpy (3
   launches per step), plain (3 per step) and ``fuse_rk_pairs`` (one
   depth-2 and one depth-1 launch per step); 3-D diffusion at 512³ at
   depth 1, 2 and 3 (and 7 steps at depth 3: a depth-1 remainder); an
   f64 Fourier mode checked against its exact discrete and analytic
   decay.
4. Times (CUDA events, median after warm-up) of each kernel, its plain
   version and, for diffusion, ``F.conv{1,2,3}d`` with the merged
   stencil as a dense weight (S calls at depth S); the bound is
   max(bytes / memory rate, FLOPs / non-tensor rate) from the card's
   data sheet. Temporal rows also print the tile, its shared memory,
   the modelled bytes per step and the redundant work
   (``repro_torch.core.trafficmodel``).

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
TOL = {"float32": 1e-5, "float64": 1e-12}

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
    """(max |a - b|, that over max |b|)."""
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
                   fuse_steps=1):
    """(f_padded, ops, phi, plan, aux) of ``fuse_steps`` diffusion
    steps in one launch."""
    from repro_torch.core.boundary import pad
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.physics.diffusion import DiffusionProblem

    prob = DiffusionProblem(shape)
    op = prob.step_op("swc", block=block, fuse_steps=fuse_steps,
                      device=device)
    f = prob.init_field(seed, device=device, dtype=dtype)
    fp = pad(f, [r * fuse_steps for r in op.radius_per_axis], "periodic",
             spatial_axes=range(1, f.ndim))
    plan = plan_for_nd(op.ops, tuple(fp.shape), 1, block=block,
                       dtype=dtype, unroll=unroll, fuse_steps=fuse_steps)
    return fp, op.ops, op.phi, plan, None


def select_case(shape, dtype, device, fuse_steps, seed=0):
    """Two random fields through the whole order-6 derivative set, φ
    selecting ``dxx``: the select kind with more than one field."""
    import torch

    from repro_torch.core.stencil import derivative_operator_set
    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.kernels.phi import select_phi

    ops = derivative_operator_set(len(shape), 6, 0.3)
    g = torch.Generator(device="cpu").manual_seed(seed)
    padded = (2,) + tuple(n + 6 * fuse_steps for n in shape)
    fp = torch.rand(padded, generator=g, dtype=torch.float64).to(
        device=device, dtype=getattr(torch, dtype))
    plan = plan_for_nd(ops, padded, 2, dtype=dtype, fuse_steps=fuse_steps)
    return fp, ops, select_phi("dxx"), plan, None


def mhd_case(shape, dtype, device, substep, block=(1, 8, 32), unroll=1,
             smooth=True, seed=0):
    """(f_padded, ops, phi, plan, aux) of one MHD RHS or RK substep."""
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
    fp = pad(f, ops.radius_per_axis(), "periodic", spatial_axes=(1, 2, 3))
    if substep:
        dt = float(solver.cfl_dt(f))
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
        block=block, dtype=dtype, unroll=unroll,
    )
    return fp, ops, phi, plan, aux


def mhd_pair_case(shape, dtype, device, substeps=(1, 2), block=(1, 8, 32),
                  smooth=True, seed=0):
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
                       block=block, dtype=dtype, fuse_steps=2,
                       max_threads=256)
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


def plain(case):
    """The plain PyTorch version of a case's launch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.phi import phi_sequence

    fp, ops, phi, plan, aux = case
    phis = phi_sequence(phi, plan.fuse_steps)
    if plan.fuse_steps == 1:
        return ref.fused_stencil(fp, ops, phis[0].torch_fn, aux=aux)
    return ref.fused_stencil_steps(
        fp, ops, [p.torch_fn for p in phis], plan.fuse_steps, aux=aux)


def compare(label, case, dtype):
    from repro_torch.kernels import emit

    fp, ops, phi, plan, aux = case
    layout = emit.kernel_smem_bytes(plan)
    if layout != plan.smem_bytes:
        raise AssertionError(
            f"{label}: plan.smem_bytes {plan.smem_bytes} != the kernel's "
            f"layout {layout}")
    got = emit.fused_stencil_swc(fp, ops, phi, plan, aux=aux)
    return check(f"{label} {dtype} S{plan.fuse_steps} tile{plan.block}"
                 f"u{plan.unroll} {plan.smem_bytes}B", got, plain(case),
                 dtype)


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


def counted(fn):
    """(fn(), host seconds, launches by depth), the launch counters set
    to 0 just before and read just after, the card synchronised at both
    ends."""
    import torch

    from repro_torch.kernels import emit

    torch.cuda.synchronize()
    emit.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_depth = dict(emit.fused_stencil_swc.launches_by_depth)
    if emit.fused_stencil_swc.launches != sum(by_depth.values()):
        raise AssertionError("launch total and per-depth counts disagree")
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
    for kind in ("mhd_rhs", "mhd pair"):
        _, rel = rel_err(results[kind], results["mhd_substep"])
        print(f"  {kind} vs fused-axpy RK3 after {n_steps} steps: "
              f"rel {rel:.3e}")
        if rel > 1e-5:
            raise AssertionError(f"{kind}: the RK3 forms disagree")

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
    base = {n: simulate(prob, f0, n, strategy="swc", device=dev)
            for n in (6, 7)}
    for depth, n, want in ((2, 6, {2: 3}), (3, 6, {3: 2}),
                           (3, 7, {3: 2, 1: 1})):
        out, wall, by_depth = counted(
            lambda: simulate(prob, f0, n, strategy="swc", fuse_steps=depth,
                             device=dev))
        if by_depth != want:
            raise AssertionError(
                f"diffusion fuse_steps={depth}, {n} steps: launches "
                f"{by_depth}, want {want}")
        if n == 6:
            launches[f"select S={depth}"] = by_depth[depth]
        _, rel = rel_err(out, base[n])
        print(f"  diffusion 512^3 f32 fuse_steps={depth}: {n} steps, "
              f"launches by depth {by_depth}, {1e3 * wall / n:.2f} ms/step "
              f"(host clock); vs depth 1 rel {rel:.3e}")
        if rel > 1e-5 or not bool(torch.isfinite(out).all()):
            raise AssertionError("fused diffusion disagrees with depth 1")

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


def phase_times(dev, smi, launches):
    import torch
    import torch.nn.functional as F

    from repro_torch.core.trafficmodel import (
        stencil_hbm_bytes_per_step,
        stencil_redundant_compute_fraction,
    )
    from repro_torch.kernels.emit import fused_stencil_swc
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
        got = fused_stencil_swc(fp, ops, phi, plan, aux=aux)
        want = plain(case)
        err, rel = rel_err(got, want)
        if rel > TOL[dtype]:
            raise AssertionError(f"{label}: rel err {rel:.3e}")
        del want
        ms = time_ms(lambda: fused_stencil_swc(fp, ops, phi, plan, aux=aux),
                     reps)
        plain_ms = time_ms(lambda: plain(case), plain_reps, warmup=1)
        lib_ms = None
        if library is not None:
            lib_out = library()
            lerr, _ = rel_err(lib_out.reshape(got.shape), got)
            lib_ms = time_ms(library, reps)
            print(f"    library conv vs kernel max|err| {lerr:.3e}")
        points = 1
        for n_ in plan.interior:
            points *= n_
        nbytes = (fp.numel() + got.numel()
                  + (0 if aux is None else aux.numel())) * item
        flops = depth * (ops.flops_per_point(plan.n_f) + phi_flops) * points
        t_bytes = nbytes / bw * 1e3
        t_ops = flops / (f32_rate if item == 4 else f64_rate) * 1e3
        bound = max(t_bytes, t_ops)
        r = {
            "name": (f"fused_stencil_swc[{kind}]" if depth == 1 else
                     f"fused_stencil_temporal[{kind}, S={depth}]"),
            "route": "cuda",
            "source": KERNEL_SOURCE if depth == 1 else TEMPORAL_SOURCE,
            "replaces": REPLACES if depth == 1 else TEMPORAL_REPLACES,
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
        if depth > 1:
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
        x = fp[None]

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
    for shape in ((1 << 26,), (8192, 8192)):
        case = diffusion_case(shape, "float32", dev)
        row(f"diffusion {shape}", "select", case, "float32", 0,
            conv_of(case))
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
    return rows


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch

    dev = repro_torch.default_device()
    smi = phase_card()
    print(smi)
    phase_parity(dev)
    if "--quick" in argv:
        return 0
    launches = phase_main_path(dev)
    rows = phase_times(dev, smi, launches)
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
