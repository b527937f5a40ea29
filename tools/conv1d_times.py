#!/usr/bin/env python3
"""Time the B7 depthwise causal conv kernel (``csrc/conv1d_depthwise.cu``)
alone on the card at mamba2-780m's prefill launch, at the wrapper's
defaults and in variants, each held to its plain version first (bit for
bit).

    PYTHONPATH=src python3 tools/conv1d_times.py            # every row
    PYTHONPATH=src python3 tools/conv1d_times.py --default  # defaults only
    PYTHONPATH=src python3 tools/conv1d_times.py --dtype float16,float64 --k 4,16,33
    PYTHONPATH=<other tree>/src python3 tools/conv1d_times.py --default

The default rows call ``ops.conv1d_depthwise`` as the model does, so with
another tree's package on the path (say the parent commit) they time
that tree's kernel, and two trees compare within one call on one card.

Rows (CUDA events, median of 20 after 2 warm-ups, per launch): the xBC
view (4, 8192, 3328) of a (4, 8192, 6448) in-projection at offset 3072
(the main path's launch) and a contiguous copy of it, in the dtypes
``--dtype`` lists (a comma list; bf16 and f32 by default) and at the
tap counts ``--k`` lists (4 by default; past 8 the kernel's body with k
at run time), activation none; then SiLU on the view. A variant (this
tree only) starts the view 1 or 2 channels later (offset 3073: single
channels; 3074: 2-byte pairs, single f32 channels), which narrows the
vector width.
Each row prints its bound (chip_smoke.py's: bytes), the share of it
reached, and (this tree) the channels per lane,
the grid, and the kernel's registers and spills; a copy (``clone``) of
the contiguous input, reading and writing the bytes the kernel moves, is
timed first as what the card's memory gives. Prints the card's name and
power limit first. Needs a CUDA card.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# view offsets that narrow the vector width
NARROWER = {"bfloat16": (3074, 3073), "float16": (3074, 3073),
            "float32": (3073,), "float64": (3073,)}
MANGLED = {"float32": "f", "float64": "d", "bfloat16": "13__nv_bfloat16",
           "float16": "6__half"}


def _launch_info(kc, cs, x, w, act, dtype, vec) -> str:
    """Channels per lane, grid and registers (this tree's wrapper only)."""
    if not hasattr(kc, "kernel_grid"):
        return ""
    b, s, c = x.shape
    k = w.shape[0]
    grid = kc.kernel_grid(b, s, c, k, act, dtype, vec)
    t = MANGLED[dtype]
    body = kc.tap_body(k) if hasattr(kc, "tap_body") else k
    key = (f"conv1d_depthwise_kernelI{t}Li{vec}ELi{body}E"
           f"Li{kc.ACTIVATIONS.index(act)}E")
    return (f"  vec {vec}, grid {grid} x {kc.THREADS}, "
            f"{cs._usage_of('conv1d_depthwise', key)}")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("conv1d_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import conv1d_depthwise as kc
    from repro_torch.kernels import ops as kops

    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]))
    build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    bw, _, _ = cs.card_rates(torch.cuda.get_device_name(0))
    default_only = "--default" in argv
    dtypes, taps = ("bfloat16", "float32"), (4,)
    if "--dtype" in argv:
        dtypes = tuple(argv[argv.index("--dtype") + 1].split(","))
    if "--k" in argv:
        taps = tuple(int(k) for k in argv[argv.index("--k") + 1].split(","))
    b, s = cs.PREFILL_SHAPE
    c, row = 3328, 6448
    for dtype, k in ((dt, k) for dt in dtypes for k in taps):
        view, w = cs.conv_inputs((b, s, c), k, dtype, dev, seed=11, row=row,
                                 offset=3072)
        item = view.element_size()
        bound = ((b * (s + k - 1) + k) * c + b * s * c) * item / bw * 1e3
        contiguous = view.contiguous()
        copy_ms = cs.time_ms(lambda: contiguous.clone(), 20)
        print(f"copy of the contiguous input {b}x{s}x{c} {dtype} (the "
              f"card's rate for these bytes, a yardstick) {copy_ms:.4f} ms",
              flush=True)
        cases = [("xBC view", view, "none", "default"),
                 ("contiguous", contiguous, "none", "default"),
                 ("xBC view", view, "silu", "default")]
        if not default_only:
            for offset in NARROWER[dtype]:
                full = torch.empty((b, s, row), dtype=view.dtype, device=dev)
                x = full[..., offset:offset + c]
                x.copy_(view)
                cases.append(("xBC view", x, "none", f"+{offset - 3072}"))
        for label, x, act, name in cases:
            def call(x=x, act=act):
                return kops.conv1d_depthwise(x, w, activation=act)
            want = ref.conv1d_depthwise(x, w, act)
            got = call()
            same = bool(torch.equal(got, want))
            _, rel = cs.rel_err(got, want)
            if act == "none" and not same or rel > cs.TOL[dtype]:
                raise AssertionError(f"{label} {dtype} {act}: rel err "
                                     f"{rel:.3e}, equal {same}")
            del got, want
            ms = cs.time_ms(call, 20)
            info = "" if default_only else _launch_info(
                kc, cs, x, w, act, dtype, kc.vector_width(x, w))
            print(f"{label:<10} {b}x{s}x{c} k={k} {dtype:<8} {act:<4} "
                  f"{name:<8} {ms:8.4f} ms  bound {bound:.4f} (bytes) "
                  f"{bound / ms:6.1%}  {'=' if same else '~'}{info}",
                  flush=True)
        del view, w, cases, contiguous
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
