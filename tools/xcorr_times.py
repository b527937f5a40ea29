#!/usr/bin/env python3
"""Time the B6 cross-correlation kernel (``csrc/xcorr1d.cu``) alone on the
card: the paper's strategies at n = 2^24 and the 2^26 ``step_1d_xcorr``
launch, at the wrapper's defaults and in variants, each held to its plain
version first.

    PYTHONPATH=src python3 tools/xcorr_times.py            # every row
    PYTHONPATH=src python3 tools/xcorr_times.py --default  # defaults only
    PYTHONPATH=src python3 tools/xcorr_times.py --dtype bfloat16,float16
    PYTHONPATH=src python3 tools/xcorr_times.py --routes --dtype bfloat16
    PYTHONPATH=<other tree>/src python3 tools/xcorr_times.py --default

The default rows call ``ops.xcorr1d`` as the main path does, so with
another tree's package on the path (say the parent commit) they time
that tree's kernel, and two trees compare within one call on one card.

Rows (CUDA events, median of 10 after 2 warm-ups, per launch), in the
dtypes ``--dtype`` lists (a comma list; float32 and float64 by
default): f32 at r = 1, 4, 8, 10, 16, 64, 256, 1024 (chip_smoke.py's),
f64 at r = 1, 10 and 1024, bf16 and f16 at r = 1, 5, 10, 32 and 1024,
n = 2^24, each of baseline, pointwise (U = 4) and elementwise (U = 4,
8, 16), block_size 2048, and at r = 1024 elementwise at U = 32 and 64
and pointwise at 24 and 64 (register passes); the 2^26 launch of
``step_1d_xcorr`` (r = 3) on each strategy at U = 4, in each listed
dtype but f64. A variant (this tree only) sets the block_size (1024,
4096) or moves f one element off 16 bytes (``f+1``: the ring stages it
element by element), at elementwise U = 8 r = 1024 f32, U = 8 r = 1024
f64, U = 4 on the 2^26 launch and baseline on the 2^26 launch; and
elementwise at U = 4, 8, 16 at r = 5, 10 and 32 runs on both launches
(``route=one-tile``, ``route=ring``), which sets ``RING_MIN_TAPS``:
those rows call two copies of ``csrc/xcorr1d.cu`` that this tool builds
for itself into ``build/xcorr_times/`` with the launch forced
(``-DXCORR_FORCE_ROUTE=1`` or ``2``; the port's library keeps its rule),
through their C entry point. ``--routes`` runs only those radii's
elementwise rows. Each row prints its
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
RADII = {"float64": (1, 10, 1024), "bfloat16": (1, 5, 10, 32, 1024),
         "float16": (1, 5, 10, 32, 1024)}  # float32: XCORR_TIME_RADII
MANGLED = {"float32": "f", "float64": "d", "bfloat16": "13__nv_bfloat16",
           "float16": "6__half"}
# The radii around the ring's first taps: elementwise on both launches.
ROUTE_RADII = (5, 10, 32)
ROUTES = (("route=one-tile", "one-tile"), ("route=ring", "ring"))
ROUTE_CODES = {"one-tile": 1, "ring": 2}  # XCORR_FORCE_ROUTE of xcorr1d.cu
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


def _route_libs(build, kx) -> dict:
    """``csrc/xcorr1d.cu`` built for this tool with each launch forced
    (``-DXCORR_FORCE_ROUTE``), both at once, into ``build/xcorr_times/``:
    {route: the loaded library, its C signatures declared}."""
    import ctypes
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    out_dir = ROOT / "build" / "xcorr_times"
    out_dir.mkdir(parents=True, exist_ok=True)
    port = kx._lib()

    def one(route):
        lib = out_dir / f"libxcorr1d_{route}.so"
        proc = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS,
             f"-DXCORR_FORCE_ROUTE={ROUTE_CODES[route]}", "-I",
             str(build.CSRC), "-o", str(lib),
             str(build.CSRC / "xcorr1d.cu")],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {lib.name}:\n"
                               f"{proc.stderr[-4000:]}")
        cdll = ctypes.CDLL(str(lib))
        for fn in ("repro_xcorr1d", "repro_xcorr1d_layout",
                   "repro_xcorr1d_grid"):
            getattr(cdll, fn).argtypes = getattr(port, fn).argtypes
            getattr(cdll, fn).restype = getattr(port, fn).restype
        return route, cdll

    with ThreadPoolExecutor(max_workers=len(ROUTE_CODES)) as pool:
        return dict(pool.map(one, ROUTE_CODES))


def _forced_call(lib, kx, f, g, strategy, unroll, block_size=2048):
    """One launch of ``lib`` (a :func:`_route_libs` build) as
    ``xcorr1d_cuda`` makes it, into a new output."""
    import torch

    n_taps = g.shape[0]
    n = f.shape[0] - n_taps + 1
    out = torch.empty((n,), dtype=f.dtype, device=f.device)
    err = lib.repro_xcorr1d(
        f.data_ptr(), g.data_ptr(), out.data_ptr(), n, n_taps, block_size,
        kx.MODES[strategy], kx.kernel_unroll(strategy, unroll),
        kx.DTYPE_CODES[kx.dtype_name(f.dtype)], f.device.index or 0,
        torch.cuda.current_stream(f.device).cuda_stream)
    if err:
        raise RuntimeError(f"forced xcorr1d launch failed: CUDA error {err}")
    return out


def _forced_info(lib, kx, cs, n, n_taps, dtype, strategy, unroll) -> str:
    """The launch of ``lib`` (a :func:`_route_libs` build) by its own
    layout: route, stages, shared bytes, grid, threads and registers."""
    import ctypes

    u = kx.kernel_unroll(strategy, unroll)
    code = kx.DTYPE_CODES[dtype]
    vals = (ctypes.c_longlong * 16)()
    count = lib.repro_xcorr1d_layout(n_taps, 2048, kx.MODES[strategy], u,
                                     code, vals)
    _, fields = kx.decode_layout(vals[:count])
    grid = lib.repro_xcorr1d_grid(n, n_taps, 2048, kx.MODES[strategy], u,
                                  code, 0)
    ur = kx.register_unroll(u)
    t = MANGLED[dtype]
    if fields["route"]:
        launch = f"ring of {fields['stages']}"
        key = f"ring_kernelI{t}Li{ur}E"
    else:
        launch = "one-tile"
        key = f"tile_kernelI{t}Li{kx.MODES[strategy]}ELi{ur}E"
    return (f"  {launch}, {fields['total']} B, grid {grid} x "
            f"{fields['threads']}, {cs._usage_of('xcorr1d', key)}")


def _launch_info(kx, cs, n, n_taps, dtype, strategy, unroll, kw) -> str:
    """The launch, shared bytes, grid, threads and registers (this tree's
    wrapper only)."""
    if not hasattr(kx, "ring_route"):
        return ""
    block = kw.get("block_size", 2048)
    threads, smem = kx.kernel_layout(n_taps, block, strategy, unroll, dtype)
    grid = kx.kernel_grid(n, n_taps, block, strategy, unroll, dtype)
    u = kx.kernel_unroll(strategy, unroll)
    ur = kx.register_unroll(u) if hasattr(kx, "register_unroll") else u
    t = MANGLED[dtype]
    if kx.ring_route(strategy, u, n_taps):
        stages = kx.ring_stages(n_taps, block, dtype, strategy, unroll)
        launch, key = f"ring of {stages}", f"ring_kernelI{t}Li{ur}E"
    else:
        launch = "one-tile"
        key = f"tile_kernelI{t}Li{kx.MODES[strategy]}ELi{ur}E"
    if ur != u:
        launch += f" ({u // ur} passes of {ur})"
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

    try:  # float64 to float16 rounded once; older trees cast by .to()
        from repro_torch import cast
    except ImportError:
        def cast(t, dtype):
            return t.to(dtype)

    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]))
    build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    bw, f32_rate, f64_rate = cs.card_rates(torch.cuda.get_device_name(0))
    default_only = "--default" in argv
    routes_only = "--routes" in argv
    route_libs = {} if default_only else _route_libs(build, kx)
    dtypes = ("float32", "float64")
    if "--dtype" in argv:
        dtypes = tuple(argv[argv.index("--dtype") + 1].split(","))

    def rows(label, f, g, dtype, strategies, routes=False):
        n_taps = g.shape[0]
        n = f.shape[0] - n_taps + 1
        item = f.element_size()
        t_bytes = (f.numel() + n_taps + n) * item / bw * 1e3
        rate = {8: f64_rate, 4: f32_rate, 2: cs.BF16_PAIR * f32_rate}[item]
        t_ops = 2 * n_taps * n / rate * 1e3
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
            if not default_only and routes and strategy == "elementwise":
                variants += tuple((name, {"route": route}, 0)
                                  for name, route in ROUTES)
            for name, kw, offset in variants:
                if "route" in kw:
                    def call(lib=route_libs[kw["route"]]):
                        return _forced_call(lib, kx, f, g, strategy, unroll)
                elif name != "default":
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
                got = call()
                _, rel = cs.rel_err(got, want)
                if rel > cs.TOL[dtype] or (
                        item == 2 and not torch.equal(got, want)):
                    raise AssertionError(f"{label} {strategy}: rel err "
                                         f"{rel:.3e}")
                del got
                ms = cs.time_ms(call, 10)
                info = ""
                if "route" in kw:
                    info = _forced_info(route_libs[kw["route"]], kx, cs, n,
                                        n_taps, dtype, strategy, unroll)
                elif not default_only:
                    info = _launch_info(kx, cs, n, n_taps, dtype, strategy,
                                        unroll, kw)
                print(f"{label:<23} {dtype:<7} {strategy:<11} u{unroll:<2} "
                      f"{name:<16} {ms:9.4f} ms  bound "
                      f"{bound:.4f} ({by}) {bound / ms:6.1%}  rel "
                      f"{rel:.2e}{info}", flush=True)
        del want

    n = 1 << 24
    for dtype in dtypes:
        for r in RADII.get(dtype, cs.XCORR_TIME_RADII):
            if routes_only and r not in ROUTE_RADII:
                continue
            f, g = cs.xcorr_inputs(n, r, dtype, dev, seed=r)
            wide = cs.XCORR_WIDE if r == 1024 and not default_only else ()
            strategies = STRATEGIES + wide
            if routes_only:
                strategies = tuple(s for s in STRATEGIES
                                   if s[0] == "elementwise")
            rows(f"n=2^24 r={r}", f, g, dtype, strategies,
                 routes=r in ROUTE_RADII)
            del f, g
            torch.cuda.empty_cache()
    prob = DiffusionProblem((1 << 26,), accuracy=6)
    taps = torch.as_tensor(diffusion_kernel_1d(prob.accuracy, prob.dt,
                                               prob.alpha, prob.spacing[0]),
                           dtype=torch.float64, device=dev)
    for dtype in dtypes:
        if dtype == "float64" or routes_only:
            continue
        f0 = prob.init_field(seed=0, device=dev, dtype=dtype)[0]
        r = prob.radius
        fp = torch.cat([f0[-r:], f0, f0[:r]])
        rows("step_1d_xcorr 2^26 r=3", fp, cast(taps, fp.dtype), dtype,
             cs.XCORR_STRATEGIES)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
