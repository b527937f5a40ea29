"""Registered shapes for cache pre-warming (port of
``repro.tuning.shapes``).

``python -m repro_torch.tuning warm`` drives every entry through the
real ``"auto"`` call sites, so the tuner measures (on the card) and the
winners persist, with the exact key derivation the hot paths use: warm
once, every later ``FusedStencilOp``/kernel call hits the cache. The
``--full`` extents are the main path's (``chip_smoke.py``): diffusion at
512³, 8192² and 2^26 (order 6), the MHD RHS at 256³ f32, B6 at 2^24
with r = 1024; the small ones run in seconds. A CPU device resolves
every entry by the model alone.

``AUDIT_SHAPES`` (port of the reference's static-audit registry) is the
set of problems ``repro_torch.analysis`` proves every plan of: the
reference's eight entries under their names and smoke extents, their
``full`` extents the main path's sizes in ``chip_smoke.py``, plus what
the port runs that the reference's registry lacks.
"""
from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Callable, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WarmEntry:
    name: str
    run: Callable[[bool, object], None]  # run(full, device)


def _diffusion(shape, strategies, device) -> None:
    from repro_torch.physics.diffusion import DiffusionProblem

    p = DiffusionProblem(shape, accuracy=6)
    f0 = p.init_field(device=device)
    for strategy in strategies:
        if strategy == "auto":
            p.step_op("auto", fuse_steps="auto", device=device).resolved(f0)
        else:
            p.step_op(strategy, block="auto", device=device)(f0)


def _warm_diffusion3d(full: bool, device) -> None:
    _diffusion((512,) * 3 if full else (16, 16, 64),
               ("swc", "swc_stream", "tc", "auto"), device)


def _warm_diffusion2d(full: bool, device) -> None:
    _diffusion((8192, 8192) if full else (64, 128),
               ("swc", "swc_stream", "tc", "auto"), device)


def _warm_diffusion1d(full: bool, device) -> None:
    _diffusion((1 << 26,) if full else (1 << 14,), ("swc", "tc", "auto"),
               device)


def _warm_mhd(full: bool, device) -> None:
    from repro_torch.physics.mhd import MHDSolver

    n = 256 if full else 16
    solver = MHDSolver((n, n, n), strategy="auto", device=device)
    solver.rhs(solver.init_fields())


def _warm_xcorr1d(full: bool, device) -> None:
    from repro_torch import resolve_device
    from repro_torch.kernels import ops as kops

    device = resolve_device(device)
    n, radius = (1 << 24, 1024) if full else (1 << 16, 32)
    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.standard_normal(n + 2 * radius),
                        dtype=torch.float32, device=device)
    g = torch.as_tensor(rng.standard_normal(2 * radius + 1),
                        dtype=torch.float32, device=device)
    kops.xcorr1d(f, g, strategy="elementwise", block_size="auto")


def warm_model_kernels(cfg, batch: int, seq_len: int, dtype=None,
                       device=None) -> int:
    """Resolve the kernel blocks a model's hot path requests under
    ``--auto-tune`` (mamba2's depthwise conv; the other families launch
    no stencil kernel) at its (batch, seq_len) in its compute dtype, so
    the later steps hit the cache. Returns the number of shapes warmed.
    B7's ``block_seq`` changes nothing in its launch, so its record is
    the model's (``tuning.session.auto_block_conv1d``)."""
    if cfg.family != "ssm":
        return 0
    from repro_torch import as_dtype, resolve_device
    from repro_torch.kernels import ops as kops
    from repro_torch.models.ssm import _dims

    device = resolve_device(device)
    dtype = as_dtype(dtype or cfg.dtype)
    conv_ch = _dims(cfg)[-1]
    x = torch.zeros((batch, seq_len, conv_ch), dtype=dtype, device=device)
    w = torch.zeros((cfg.ssm_conv_kernel, conv_ch), dtype=dtype,
                    device=device)
    kops.conv1d_depthwise(x, w, block_seq="auto")
    return 1


def _warm_mamba2(full: bool, device) -> None:
    from repro_torch.configs.registry import get_config, reduced_config

    cfg = get_config("mamba2-780m")
    if not full:
        cfg = reduced_config(cfg)
    warm_model_kernels(cfg, 4, 8192 if full else 64, device=device)


REGISTRY: tuple[WarmEntry, ...] = (
    WarmEntry("diffusion3d/swc,swc_stream,tc,auto", _warm_diffusion3d),
    WarmEntry("diffusion2d/swc,swc_stream,tc,auto", _warm_diffusion2d),
    WarmEntry("diffusion1d/swc,tc,auto", _warm_diffusion1d),
    WarmEntry("mhd/auto", _warm_mhd),
    WarmEntry("xcorr1d/elementwise", _warm_xcorr1d),
    WarmEntry("mamba2/conv1d_depthwise", _warm_mamba2),
)


# ---------------------------------------------------------------------------
# Static-audit shapes (repro_torch.analysis)
# ---------------------------------------------------------------------------

# φ kinds: (threads limit, operator slots) as the dispatch passes them to
# plan_for_nd (kernels/ops.py:_max_threads_of, _slots_of).
PHI_KINDS = {"select": (1024, 1), "mhd_rhs": (256, 10),
             "mhd_substep": (256, 10)}


def not_ported_item(err: Exception) -> str:
    """The ROADMAP item a NotImplementedError names (B2c, B4b, ...)."""
    m = re.search(r"ROADMAP (\w+)", str(err))
    return m.group(1) if m else "unknown"


@dataclasses.dataclass(frozen=True)
class AuditShape:
    """One entry of the static-audit registry: every plan of the cross
    product of its axes (strategies × fuse × unroll × batch) over this
    problem, built as the dispatch builds it (``kernels.ops.plan_for_nd``
    with the φ kind's threads and slots), is proved by the auditor; no
    kernel runs. ``kernel`` "fused" is the fused stencil (B1-B5);
    "xcorr1d" (B6: ``taps`` = 2r + 1, ``strategies`` the B6 strategies,
    ``unroll`` their factors) and "conv1d" (B7: extents (b, s, c),
    ``taps`` = k) are the 1-D kernels. ``accuracy=0`` selects the
    reference's hand-built cross-correlation taps."""

    name: str
    ndim: int
    accuracy: int
    smoke: tuple[int, ...]
    full: tuple[int, ...]
    n_f: int = 1
    n_out: int = 1
    n_aux: int = 0
    dtype: str = "float32"
    strategies: tuple[str, ...] = ("swc",)
    fuse: tuple[int, ...] = (1,)
    unroll: tuple[int, ...] = (1,)
    batch: tuple[int, ...] = (1,)
    phi: str = "select"
    kernel: str = "fused"
    taps: int = 0

    def operator_set(self):
        import numpy as _np

        from repro_torch.core.stencil import (
            derivative_operator_set,
            xcorr_operator_set,
        )

        if self.accuracy == 0:
            g = _np.arange(1, 2 * 32 + 2, dtype=_np.float64)
            return xcorr_operator_set(g, self.ndim)
        return derivative_operator_set(self.ndim, self.accuracy)

    def plans(self, domain: tuple[int, ...]) -> Iterator[tuple]:
        """Every combination of the axes at ``domain``: ("plan", plan,
        ops), ("not_ported", ROADMAP item, label) for a
        NotImplementedError, ("refused", reason, label) for a planner's
        ValueError. Combinations the reference's rules exclude
        (``repro/tuning/shapes.py``'s ``plans``) are skipped."""
        from repro_torch.kernels.ops import plan_for_nd

        ops = self.operator_set()
        radii = ops.radius_per_axis()
        max_threads, n_slots = PHI_KINDS[self.phi]
        for s, f, u, b in itertools.product(
                self.strategies, self.fuse, self.unroll, self.batch):
            if s == "swc_stream" and (self.ndim == 1 or self.n_aux or u != 1):
                continue
            if s == "tc" and (u != 1 or self.dtype not in ("float32",
                                                           "bfloat16")):
                continue
            if u != 1 and f != 1:
                continue
            if f > 1 and self.n_out != self.n_f + self.n_aux:
                continue
            if b > 1 and self.n_aux and f > 1:
                continue
            padded = tuple(n + 2 * r * f for n, r in zip(domain, radii))
            lead = (b,) if b > 1 else ()
            aux = None
            if self.n_aux:
                aux = lead + (self.n_aux,) + tuple(
                    n + 2 * r * (f - 1) for n, r in zip(domain, radii))
            label = f"{self.name}:{s}:f{f}:u{u}:b{b}"
            try:
                plan = plan_for_nd(
                    ops, lead + (self.n_f,) + padded, self.n_out,
                    aux_shape=aux, strategy=s, dtype=self.dtype, unroll=u,
                    fuse_steps=f, max_threads=max_threads, n_slots=n_slots)
            except NotImplementedError as e:
                yield "not_ported", not_ported_item(e), label
                continue
            except ValueError as e:
                yield "refused", str(e).split(" — ")[0][:120], label
                continue
            yield "plan", plan, ops

    def launches(self, extents: tuple[int, ...]) -> Iterator[tuple]:
        """B6 and B7 launches at ``extents``: ("launch", launch) or
        ("not_ported", ROADMAP item, label)."""
        from repro_torch.analysis.bodies import Conv1dLaunch, XcorrLaunch
        from repro_torch.kernels import conv1d_depthwise as kc
        from repro_torch.kernels import xcorr1d as kx

        if self.kernel == "xcorr1d":
            (n,) = extents
            for s, u in itertools.product(self.strategies, self.unroll):
                label = f"{self.name}:{s}:u{u}"
                try:
                    kx.check_args(s, 2048, u)
                    kx.check_launch(self.taps, 2048, s, u, self.dtype)
                except NotImplementedError as e:
                    yield "not_ported", not_ported_item(e), label
                    continue
                for wide in (True, False):
                    yield "launch", XcorrLaunch(n, self.taps, 2048, s, u,
                                                self.dtype, wide)
            return
        b, s, c = extents
        try:
            kc.check_launch(b, s, c, self.taps, 512, self.dtype)
        except NotImplementedError as e:
            yield "not_ported", not_ported_item(e), self.name
            return
        item = kc.ITEMSIZE[self.dtype]
        wide = 16 // item
        for vec in dict.fromkeys((wide, 2 if item == 2 else 1, 1)):
            if c % vec == 0:
                yield "launch", Conv1dLaunch(b, s, c, self.taps, self.dtype,
                                             vec)


_MAIN_3D = (512, 512, 512)
_MAIN_2D = (8192, 8192)
_MAIN_1D = (1 << 26,)
_MHD = (256, 256, 256)


def _mhd(name, smoke, full, phi, dtype="float32", strategies=("swc",),
         fuse=(1,), batch=(1,)):
    aux = 8 if phi == "mhd_substep" else 0
    return AuditShape(name, 3, 6, smoke, full, n_f=8, n_out=8 + aux,
                      n_aux=aux, dtype=dtype, strategies=strategies,
                      fuse=fuse, batch=batch, phi=phi)


# The reference's eight entries (same names and smoke extents; full the
# main path's sizes), then the port's own: bf16 and f64 diffusion, the
# MHD kinds (the RHS twice, the substep with aux and the pair, f32, f64
# and bf16), the serve buckets (B = 8, order 2), the sharded blocks and the
# overlap slabs of distribution (diffusion 512³ over (2,) and (2, 2), MHD
# 256³ over (2,): halo r·S = 3 at depth 1 and 6 at depth 2 per sharded
# axis), float16 diffusion (not ported: ROADMAP B9), then B6 (f32/f64 at
# unroll 4-16; bf16/f16 at 4-64, B6b) and B7 (f32/bf16 at k = 4, 7;
# f16/f64 at k = 4, 7, 12, B7b).
AUDIT_SHAPES: tuple[AuditShape, ...] = (
    AuditShape("fig11/diffusion3d", 3, 2, (32, 32, 64), _MAIN_3D,
               strategies=("swc", "swc_stream", "tc"), fuse=(1, 2)),
    AuditShape("fig11/diffusion3d_o6", 3, 6, (32, 32, 64), _MAIN_3D,
               strategies=("swc", "swc_stream", "tc"), fuse=(1, 2, 3)),
    AuditShape("fig11/diffusion1d", 1, 6, (1 << 14,), _MAIN_1D,
               strategies=("swc", "tc"), fuse=(1, 2), unroll=(1, 2)),
    AuditShape("fig11/diffusion2d", 2, 6, (64, 128), _MAIN_2D,
               strategies=("swc", "swc_stream", "tc"), fuse=(1, 2, 3),
               unroll=(1, 2), batch=(1, 2, 4)),
    _mhd("fig13-14/mhd8f", (16, 16, 64), _MHD, "mhd_rhs",
         strategies=("swc", "swc_stream", "tc")),
    AuditShape("engine/rk-aux-carry", 2, 6, (64, 128), _MAIN_2D, n_f=1,
               n_out=2, n_aux=1, strategies=("swc", "tc"), fuse=(1, 2)),
    AuditShape("fig07-09/xcorr1d-r32", 1, 0, (1 << 14,), _MAIN_1D,
               strategies=("swc",), unroll=(1, 2)),
    AuditShape("fig11/diffusion2d_bf16", 2, 6, (64, 128), _MAIN_2D,
               dtype="bfloat16", strategies=("swc", "swc_stream", "tc"),
               fuse=(1, 2, 3)),
    AuditShape("fig11/diffusion3d_bf16", 3, 6, (16, 16, 64), _MAIN_3D,
               dtype="bfloat16", strategies=("swc", "swc_stream", "tc"),
               fuse=(1, 2, 3)),
    AuditShape("fig11/diffusion1d_bf16", 1, 6, (1 << 14,), _MAIN_1D,
               dtype="bfloat16", strategies=("swc", "tc"), fuse=(1, 2)),
    AuditShape("fig11/diffusion3d_f64", 3, 6, (16, 16, 64), (256,) * 3,
               dtype="float64", strategies=("swc", "swc_stream"),
               fuse=(1, 2, 3)),
    _mhd("mhd/rhs_twice", (16, 16, 64), _MHD, "mhd_rhs",
         strategies=("swc", "swc_stream", "tc"), fuse=(2,)),
    _mhd("mhd/substep", (16, 16, 64), _MHD, "mhd_substep",
         strategies=("swc", "tc"), fuse=(1, 2), batch=(1, 2)),
    _mhd("mhd/rhs_f64", (16, 16, 64), _MHD, "mhd_rhs", dtype="float64",
         strategies=("swc", "swc_stream"), fuse=(1, 2)),
    _mhd("mhd/substep_f64", (16, 16, 64), _MHD, "mhd_substep",
         dtype="float64", fuse=(1, 2)),
    _mhd("mhd/rhs_bf16", (16, 16, 64), _MHD, "mhd_rhs", dtype="bfloat16",
         strategies=("swc", "swc_stream", "tc")),
    _mhd("mhd/substep_bf16", (16, 16, 64), _MHD, "mhd_substep",
         dtype="bfloat16", strategies=("swc", "tc"), fuse=(1, 2)),
    AuditShape("serve/256^3", 3, 2, (16, 16, 64), (256,) * 3,
               strategies=("swc", "swc_stream", "tc"), batch=(8,)),
    AuditShape("serve/4096^2", 2, 2, (64, 128), (4096, 4096),
               strategies=("swc", "swc_stream", "tc"), batch=(8,)),
    AuditShape("shard/z", 3, 6, (16, 32, 64), (256, 512, 512),
               strategies=("swc", "tc")),
    AuditShape("shard/y", 3, 6, (32, 16, 64), (512, 256, 512),
               strategies=("swc_stream",)),
    AuditShape("shard/zy", 3, 6, (16, 16, 64), (256, 256, 512),
               strategies=("swc", "tc"), fuse=(1, 2)),
    AuditShape("slab/zy-interior-d1", 3, 6, (10, 10, 64), (250, 250, 512),
               strategies=("swc", "tc")),
    AuditShape("slab/zy-interior-d2", 3, 6, (4, 4, 64), (244, 244, 512),
               fuse=(2,)),
    AuditShape("slab/z-edge-d1", 3, 6, (3, 16, 64), (3, 256, 512),
               strategies=("swc", "tc")),
    AuditShape("slab/y-edge-d1", 3, 6, (16, 3, 64), (256, 3, 512),
               strategies=("swc", "tc")),
    AuditShape("slab/z-edge-d2", 3, 6, (6, 16, 64), (6, 256, 512),
               fuse=(2,)),
    AuditShape("slab/y-edge-d2", 3, 6, (16, 6, 64), (256, 6, 512),
               fuse=(2,)),
    _mhd("shard/mhd-z", (8, 16, 64), (128, 256, 256), "mhd_rhs",
         strategies=("swc", "tc")),
    _mhd("shard/mhd-substep-z", (8, 16, 64), (128, 256, 256),
         "mhd_substep", fuse=(1, 2)),
    _mhd("slab/mhd-interior-d1", (10, 16, 64), (122, 256, 256), "mhd_rhs",
         strategies=("swc", "tc")),
    _mhd("slab/mhd-edge-d1", (3, 16, 64), (3, 256, 256), "mhd_rhs",
         strategies=("swc", "tc")),
    _mhd("slab/mhd-pair-interior-d2", (4, 16, 64), (116, 256, 256),
         "mhd_substep", fuse=(2,)),
    _mhd("slab/mhd-pair-edge-d2", (6, 16, 64), (6, 256, 256),
         "mhd_substep", fuse=(2,)),
    AuditShape("b9/diffusion3d-float16", 3, 6, (32, 32, 64), _MAIN_3D,
               dtype="float16", strategies=("swc", "swc_stream", "tc"),
               fuse=(1, 2)),
) + tuple(
    AuditShape(f"b6/xcorr1d-r{r}-{dt[5:]}", 1, 0, ((1 << 14) + 123,),
               (1 << 24,), dtype=dt, kernel="xcorr1d", taps=2 * r + 1,
               strategies=("baseline", "pointwise", "elementwise"),
               unroll=(4, 8, 16))
    for r in (1, 10, 64, 1024) for dt in ("float32", "float64")
) + tuple(
    AuditShape(f"b6/xcorr1d-r{r}-{dt}", 1, 0, ((1 << 14) + 123,),
               (1 << 24,), dtype=dt, kernel="xcorr1d", taps=2 * r + 1,
               strategies=("baseline", "pointwise", "elementwise"),
               unroll=(4, 8, 16, 32, 64))
    for r in (1, 10, 64, 1024) for dt in ("bfloat16", "float16")
) + tuple(
    AuditShape(f"b7/conv1d-k{k}-{dt}", 1, 0, (2, 257, 32), (4, 8192, 3328),
               dtype=dt, kernel="conv1d", taps=k)
    for k in (4, 7) for dt in ("float32", "bfloat16")
) + tuple(
    AuditShape(f"b7/conv1d-k{k}-{dt}", 1, 0, (2, 257, 32), (4, 8192, 3328),
               dtype=dt, kernel="conv1d", taps=k)
    for k in (4, 7, 12) for dt in ("float16", "float64")
)
