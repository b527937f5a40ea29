#!/usr/bin/env python3
"""Time the B6 cross-correlation kernel (``csrc/xcorr1d.cu``) alone on the
card: the paper's strategies at n = 2^24 and the 2^26 ``step_1d_xcorr``
launch, at the wrapper's defaults and in variants, each held to its plain
version first.

    PYTHONPATH=src python3 tools/xcorr_times.py            # every row
    PYTHONPATH=src python3 tools/xcorr_times.py --default  # defaults only
    PYTHONPATH=<other tree>/src python3 tools/xcorr_times.py --default

The default rows call ``ops.xcorr1d`` as the main path does, so with
another tree's package on the path (say the parent commit) they time
that tree's kernel, and two trees compare within one call on one card.

Rows (CUDA events, median of 10 after 2 warm-ups, per launch): f32 at r
= 1, 4, 8, 10, 16, 64, 256, 1024 (chip_smoke.py's) and f64 at r = 1, 10
and 1024, n = 2^24, each of
baseline, pointwise (U = 4) and elementwise (U = 4, 8, 16), block_size
2048; the 2^26 launch of ``step_1d_xcorr`` (r = 3, f32) on each strategy
at U = 4. A variant (this tree only) sets the block_size (1024, 4096) or
moves f one element off 16 bytes (``f+1``: the ring stages it element by
element), at elementwise U = 8 r = 1024 f32, U = 8 r = 1024 f64, U = 4
on the 2^26 launch and baseline on the 2^26 launch. Each row prints its
bound (chip_smoke.py's: bytes or operations), the share of it reached,
and (this tree) its launch (the ring with its windows, or one-tile),
shared bytes, grid, threads and the kernel's registers and spills; each
input's copy (``clone``, reading and writing about the bytes the kernel
moves) is timed first as what the card's memory gives. Prints the
card's name and power limit first. Needs a CUDA card.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

STRATEGIES = (("baseline", 4), ("pointwise", 4), ("elementwise", 4),
              ("elementwise", 8), ("elementwise", 16))
# (label, strategy, unroll): the rows that get variants.
VARIED = {
    ("n=2^24 r=1024", "float32", "elementwise", 8),
    ("n=2^24 r=1024", "float64", "elementwise", 8),
    ("step_1d_xcorr 2^26 r=3", "float32", "elementwise", 4),
    ("step_1d_xcorr 2^26 r=3", "float32", "baseline", 4),
}
# (name, wrapper keywords, f's offset in elements)
VARIANTS = (("block_size=1024", {"block_size": 1024}, 0),
            ("block_size=4096", {"block_size": 4096}, 0),
            ("f+1", {}, 1))


def _launch_info(kx, cs, n, n_taps, dtype, strategy, unroll, kw) -> str:
    """The launch, shared bytes, grid, threads and registers (this tree's
    wrapper only)."""
    if not hasattr(kx, "ring_route"):
        return ""
    block = kw.get("block_size", 2048)
    threads, smem = kx.kernel_layout(n_taps, block, strategy, unroll, dtype)
    grid = kx.kernel_grid(n, n_taps, block, strategy, unroll, dtype)
    u = kx.kernel_unroll(strategy, unroll)
    t = "d" if dtype == "float64" else "f"
    if kx.ring_route(strategy, u, n_taps):
        stages = kx.ring_stages(n_taps, block, dtype, strategy, unroll)
        launch, key = f"ring of {stages}", f"ring_kernelI{t}Li{u}E"
    else:
        launch = "one-tile"
        key = f"tile_kernelI{t}Li{kx.MODES[strategy]}ELi{u}E"
    return (f"  {launch}, {smem} B, grid {grid} x {threads}, "
            f"{cs._usage_of('xcorr1d', key)}")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("xcorr_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.core.stencil import diffusion_kernel_1d
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import xcorr1d as kx
    from repro_torch.physics.diffusion import DiffusionProblem

    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]))
    build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    bw, f32_rate, f64_rate = cs.card_rates(torch.cuda.get_device_name(0))
    default_only = "--default" in argv

    def rows(label, f, g, dtype, strategies):
        n_taps = g.shape[0]
        n = f.shape[0] - n_taps + 1
        item = f.element_size()
        t_bytes = (f.numel() + n_taps + n) * item / bw * 1e3
        t_ops = 2 * n_taps * n / (f64_rate if item == 8 else f32_rate) * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        want = ref.xcorr1d(f, g)
        copy_ms = cs.time_ms(lambda: f.clone(), 10)
        print(f"{label:<23} {dtype:<7} copy of f (the card's rate for "
              f"these bytes, a yardstick) {copy_ms:.4f} ms", flush=True)
        for strategy, unroll in strategies:
            variants = (("default", {}, 0),)
            if not default_only and (label, dtype, strategy,
                                     unroll) in VARIED:
                variants += VARIANTS
            for name, kw, offset in variants:
                if name != "default":
                    fv = f
                    if offset:
                        fv = torch.empty(f.numel() + offset, dtype=f.dtype,
                                         device=f.device)[offset:]
                        fv.copy_(f)

                    def call(kw=kw, fv=fv):
                        return kx.xcorr1d_cuda(fv, g, strategy=strategy,
                                               unroll=unroll, **kw)
                else:
                    def call():
                        return kops.xcorr1d(f, g, strategy=strategy,
                                            unroll=unroll)
                _, rel = cs.rel_err(call(), want)
                if rel > cs.TOL[dtype]:
                    raise AssertionError(f"{label} {strategy}: rel err "
                                         f"{rel:.3e}")
                ms = cs.time_ms(call, 10)
                info = "" if default_only else _launch_info(
                    kx, cs, n, n_taps, dtype, strategy, unroll, kw)
                print(f"{label:<23} {dtype:<7} {strategy:<11} u{unroll:<2} "
                      f"{name:<16} {ms:9.4f} ms  bound "
                      f"{bound:.4f} ({by}) {bound / ms:6.1%}  rel "
                      f"{rel:.2e}{info}", flush=True)
        del want

    n = 1 << 24
    for dtype, radii in (("float32", cs.XCORR_TIME_RADII),
                         ("float64", (1, 10, 1024))):
        for r in radii:
            f, g = cs.xcorr_inputs(n, r, dtype, dev, seed=r)
            rows(f"n=2^24 r={r}", f, g, dtype, STRATEGIES)
            del f, g
            torch.cuda.empty_cache()
    prob = DiffusionProblem((1 << 26,), accuracy=6)
    f0 = prob.init_field(seed=0, device=dev)[0]
    r = prob.radius
    fp = torch.cat([f0[-r:], f0, f0[:r]])
    g = torch.as_tensor(diffusion_kernel_1d(prob.accuracy, prob.dt,
                                            prob.alpha, prob.spacing[0]),
                        dtype=fp.dtype, device=dev)
    rows("step_1d_xcorr 2^26 r=3", fp, g, "float32", cs.XCORR_STRATEGIES)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
