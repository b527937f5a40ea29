"""Wrapper of the hand-written CUDA ``swc``, ``swc_stream`` and ``tc``
kernels (port of ``repro.kernels.emit.fused_stencil_pallas`` and
``_fused_stream``).

:func:`fused_stencil_swc` checks its operands against the plan, uploads
the operator set's tap table (once per operator set and device), and
launches on PyTorch's current stream the plan's kernel
(:func:`kernel_name`): ``csrc/fused_stencil.cu`` for ``swc`` at depth 1
(a persistent kernel, ``csrc/swc_body.cuh``),
``csrc/fused_stencil_temporal.cu`` for ``swc`` at depth > 1,
``csrc/fused_stencil_stream.cu`` for ``swc_stream`` at any depth (at
depth 1 its ring body, ``csrc/stream_body.cuh``, for the kinds
:func:`~repro_torch.kernels.plan.stream_ring_kind` takes),
``csrc/fused_stencil_tc.cu`` for ``tc`` at any depth (at depth 1 a
persistent kernel, ``csrc/tc_body.cuh``; deeper, the temporal kernel's
sweeps with the tensor-core evaluator; it takes the operator set's
:func:`tc_table` instead of the tap table). A CPU tensor goes to
the plain version (``ref.fused_stencil`` or, at depth > 1,
``ref.fused_stencil_steps``, with the φs' ``torch_fn``; their
``_batched`` forms for an ensemble; on ``tc`` their ``tc=True`` forms);
a CUDA tensor goes to the kernel, or the wrapper raises — there is no
fallback from one to the other, nor from one kernel to another.

An ensemble operand (batch, n_f, *padded) (port of ``_fused_batched``,
the TPU kernel B5) is one launch of the same kernel with the member as
an outer index: of the grid (``StencilPlan.batch``, ``grid_z``) or, in
the persistent depth-1 kernels, of the steps the blocks walk; each step
or block serves one member.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from repro_torch import dtype_name
from repro_torch.core.stencil import OperatorSet
from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.phi import DevicePhi, phi_sequence
from repro_torch.kernels.plan import (
    TC_LANES,
    StencilPlan,
    is_ensemble,
    tc_axis_groups,
    tc_band_ksteps,
    tc_table_header_words,
)

KERNEL = "fused_stencil"  # csrc/fused_stencil.cu, depth 1
TEMPORAL_KERNEL = "fused_stencil_temporal"  # csrc/fused_stencil_temporal.cu
STREAM_KERNEL = "fused_stencil_stream"  # csrc/fused_stencil_stream.cu
TC_KERNEL = "fused_stencil_tc"  # csrc/fused_stencil_tc.cu, any depth
GEOM_LEN = 44  # G_LEN of csrc/stencil_common.cuh
MAX_SLOTS = 16  # MAX_SLOTS of csrc/stencil_common.cuh
# DTYPE_* of csrc/stencil_common.cuh.
DTYPE_CODES = {"float32": 0, "float64": 1, "bfloat16": 2}
# Group table layout of csrc/fused_stencil_tc.cu.
TC_ENT_LEN = 8  # axis, rest z/y/x, lone tap, its offset, data offset, 0

TapTable = tuple[torch.Tensor, ...]


def tap_table(ops: OperatorSet) -> TapTable:
    """The operator set flattened for the kernel, on the CPU.

    Returns ``(offsets, coeffs, starts)``: int32 (n_taps, 3) offsets as
    (dz, dy, dx) — rank 1/2 offsets padded with leading zeros — float64
    coefficients (cast to the field dtype in the kernel), and int32
    (n_ops + 1,) start index of each operator's taps. Taps keep each
    operator's own order, the reference's accumulation order.
    """
    offsets, coeffs, starts = [], [], [0]
    lead = (0,) * (3 - ops.ndim)
    for spec in ops.ops:
        for off, c in zip(spec.offsets, spec.coeffs):
            offsets.append(lead + tuple(off))
            coeffs.append(c)
        starts.append(len(coeffs))
    return (
        torch.from_numpy(np.asarray(offsets, dtype=np.int32).reshape(-1, 3)),
        torch.from_numpy(np.asarray(coeffs, dtype=np.float64)),
        torch.from_numpy(np.asarray(starts, dtype=np.int32)),
    )


@functools.lru_cache(maxsize=64)
def device_tap_table(ops: OperatorSet, device: torch.device) -> TapTable:
    """:func:`tap_table` uploaded to ``device``, cached per (ops, device)."""
    return tuple(t.to(device) for t in tap_table(ops))


def tc_table(ops: OperatorSet, dtype: str = "float32") -> TapTable:
    """The operator set's ``tc`` contraction groups for
    ``csrc/fused_stencil_tc.cu``, on the CPU, for fields of ``dtype``.

    Returns ``(entries, coeffs, starts, table)``: int32 (n_groups, 8)
    rows of (axis lifted to rank 3 — 0 z, 1 y, 2 x —, rest offset (z, y,
    x), 1 for a lone tap, that tap's offset along the axis, the word
    offset of the group's data in ``table``, 0); float64 (n_groups,
    :func:`tc_coef_len`) band coefficients ``c[j + r]`` for j = -r..r, r
    the group axis's radius (zero where the group has no tap); int32
    (n_ops + 1,) start of each operator's groups; and the int32 table
    the depth-1 kernel keeps in shared memory: ``starts`` padded to 16
    bytes, the ``entries`` rows
    (:func:`~repro_torch.kernels.plan.tc_table_header_words`), then each
    group's data in group order (:func:`~repro_torch.kernels.plan.
    tc_group_words`): a lone tap's coefficient rounded to ``dtype`` (a
    double), a z arm's band rounded to ``dtype`` (2r + 1 doubles), a y
    or x contraction's band as ready MMA fragments (:func:`tc_fragments`).
    Groups follow :func:`~repro_torch.kernels.plan.tc_axis_groups` in
    sorted ``(axis, rest)`` order — the order the reference sums them —
    so each operator's groups form one contiguous run per axis, z before
    y before x.
    """
    rank = ops.ndim
    lift = 3 - rank
    radii = ops.radius_per_axis()
    entries, coeffs, starts, data = [], [], [0], []
    width = tc_coef_len(radii)
    n_words = tc_table_header_words(ops)
    for spec in ops.ops:
        for (axis, rest), taps in sorted(tc_axis_groups(spec, rank).items()):
            band = [0.0] * width
            for j, c in taps:
                band[j + radii[axis]] = c
            single = len(taps) == 1
            a = axis + lift
            own = band[:2 * radii[axis] + 1]
            if single:
                words = _band_in([taps[0][1]], dtype).view(np.uint32)
            elif a == 0:
                words = _band_in(own, dtype).view(np.uint32)
            else:
                words = tc_fragments(own, dtype, "y" if a == 1 else "x")
            words = np.concatenate(
                [words, np.zeros(-words.size % 4, np.uint32)])
            entries.append(
                [a] + [0] * lift + list(rest)
                + [int(single), taps[0][0] if single else 0, n_words, 0]
            )
            data.append(words)
            n_words += words.size
            coeffs.append(band)
        starts.append(len(entries))
    head = np.zeros(tc_table_header_words(ops) - 8 * len(entries), np.uint32)
    head[:len(starts)] = starts
    rows = np.asarray(entries, np.int64).reshape(-1).astype(np.uint32)
    table = np.concatenate([head, rows] + data)
    return (
        torch.from_numpy(np.asarray(entries, dtype=np.int32)),
        torch.from_numpy(
            np.asarray(coeffs, dtype=np.float64).reshape(-1, width)
        ),
        torch.from_numpy(np.asarray(starts, dtype=np.int32)),
        torch.from_numpy(table).view(torch.int32),
    )


def _band_in(band: list[float], dtype: str) -> np.ndarray:
    """The band's coefficients rounded to the field dtype, as the kernel's
    ``cast_coef`` rounds them (bfloat16 through float32), in float64."""
    c32 = torch.tensor(band, dtype=torch.float64).to(torch.float32)
    if dtype == "bfloat16":
        c32 = c32.to(torch.bfloat16).to(torch.float32)
    return c32.double().numpy()


def _bf16_bits(values: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint32) of values that are bfloat16."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().astype(
        np.uint32) & 0xFFFF


def tc_fragments(band: list[float], dtype: str, axis: str) -> np.ndarray:
    """One group's band ``B[k][n] = c[k - n]`` (k - n in [0, 2r], else 0)
    as the words each lane holds per k-step of the depth-1 ``tc``
    kernel's MMAs, uint32, laid out [k-step][lane][word].

    Lane l has group id g = l // 4 and thread in group t = l % 4.
    - float32 fields (f64 ``m8n8k4``): per k-step s one double,
      ``c[4s + t - g]``: B[k=4s+t][n=g] of the x contraction (window ·
      band) and A[m=g][k=4s+t] of bandᵀ in the y contraction (bandᵀ ·
      window), the same value; two words (low, high).
    - bfloat16 along x (B of ``m16n8k16``): ``{B[k][g], B[k+1][g]}`` for
      k = 16s + 2t and 16s + 2t + 8, each pair packed low first.
    - bfloat16 along y (A = bandᵀ, 16 × 16): ``{A[g][k], A[g][k+1]}``,
      ``{A[g+8][k], ..}``, ``{A[g][k+8], ..}``, ``{A[g+8][k+8], ..}`` for
      k = 16s + 2t, with A[m][k] = c[k - m].
    """
    c = _band_in(band, dtype)
    top = len(band) - 1  # 2r
    r = top // 2
    steps = tc_band_ksteps(r, dtype, axis)
    lanes = np.arange(TC_LANES)
    g, t = lanes // 4, lanes % 4

    def at(idx):
        ok = (idx >= 0) & (idx <= top)
        return np.where(ok, c[np.clip(idx, 0, top)], 0.0)

    out = []
    for s in range(steps):
        if dtype != "bfloat16":
            v = at(4 * s + t - g).astype(np.float64)
            out.append(v.view(np.uint32).reshape(TC_LANES, 2))
            continue
        k = 16 * s + 2 * t

        def pair(idx):
            return _bf16_bits(at(idx)) | (_bf16_bits(at(idx + 1)) << 16)

        if axis == "x":
            words = [pair(k - g), pair(k + 8 - g)]
        else:
            words = [pair(k - g), pair(k - g - 8), pair(k + 8 - g),
                     pair(k - g)]
        out.append(np.stack(words, axis=1).astype(np.uint32))
    return np.concatenate(out).reshape(-1)


def tc_coef_len(radii) -> int:
    """Doubles per band-coefficient row of :func:`tc_table`: 2·r_max + 1
    (the kernel reads it from the geometry, ``G_CLEN``)."""
    return 2 * max(radii) + 1


@functools.lru_cache(maxsize=64)
def device_tc_table(
    ops: OperatorSet, dtype: str, device: torch.device
) -> TapTable:
    """:func:`tc_table` uploaded to ``device``, cached per (ops, dtype,
    device)."""
    return tuple(t.to(device) for t in tc_table(ops, dtype))


@functools.lru_cache(maxsize=256)
def device_params(
    rows: tuple[tuple[float, ...], ...], device: torch.device
) -> torch.Tensor:
    """φ's parameter rows, one per sweep, as a float64 (S, n_params)
    buffer on ``device``, cached per (rows, device). The kernels read
    sweep s's row at ``s * n_params``, so no depth is fixed in them."""
    return torch.tensor(rows, dtype=torch.float64, device=device).reshape(
        len(rows), -1
    )


def kernel_name(plan: StencilPlan) -> str:
    """The ``csrc`` source whose kernel runs ``plan``."""
    if plan.strategy == "tc":
        return TC_KERNEL
    if plan.stream_axis is not None:
        return STREAM_KERNEL
    return KERNEL if plan.fuse_steps == 1 else TEMPORAL_KERNEL


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """Build/load the library of ``csrc/<name>.cu`` and declare its C
    signatures: ``repro_<name>`` (the launch),
    ``repro_<name>_smem_bytes``, ``repro_<name>_geometry_len``."""
    lib = build.load(name)
    vp = ctypes.c_void_p
    geom = ctypes.POINTER(ctypes.c_int)
    launch = getattr(lib, f"repro_{name}")
    tables = [vp] * (4 if name == TC_KERNEL else 3)  # tc: + its table
    launch.argtypes = [
        vp, vp, vp, *tables, geom, vp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp,
    ]
    launch.restype = ctypes.c_int
    if name in (KERNEL, TC_KERNEL):  # the persistent grid
        grid = getattr(lib, f"repro_{name}_grid")
        grid.argtypes = [geom, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        grid.restype = ctypes.c_longlong
    smem = getattr(lib, f"repro_{name}_smem_bytes")
    smem.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    smem.restype = ctypes.c_longlong
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    geometry_len = getattr(lib, f"repro_{name}_geometry_len")
    geometry_len.argtypes = []
    geometry_len.restype = ctypes.c_int
    if geometry_len() != GEOM_LEN:
        raise RuntimeError(f"{name}.cu geometry layout changed")
    return lib


def _int_ptr(geom: np.ndarray):
    return geom.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def kernel_smem_bytes(plan: StencilPlan) -> int:
    """Shared memory per block by the kernel's own layout for ``plan``
    (needs the built library; ``plan.smem_bytes`` must equal it)."""
    name = kernel_name(plan)
    fn = getattr(_lib(name), f"repro_{name}_smem_bytes")
    slots = list(range(plan.n_slots))
    return int(fn(_int_ptr(geometry(plan, slots)), DTYPE_CODES[plan.dtype]))


def launch_grid(plan: StencilPlan, kind_id: int, device: int = 0) -> int:
    """Blocks a persistent (depth-1 ``swc`` or ``tc``) kernel launches for
    ``plan`` with the φ kind ``kind_id``: the kernel's resident blocks per
    SM (its occupancy) times the SMs, at most ``plan.walk_items`` (needs
    the built library and the card)."""
    if not plan.persistent:
        raise ValueError("only a depth-1 swc or tc plan has a persistent grid")
    name = kernel_name(plan)
    slots = list(range(plan.n_slots))
    grid = int(getattr(_lib(name), f"repro_{name}_grid")(
        _int_ptr(geometry(plan, slots)), kind_id, DTYPE_CODES[plan.dtype],
        device,
    ))
    if grid < 0:
        raise RuntimeError(f"{name} grid query failed: CUDA error {-grid}")
    return grid


def _rank3(t: tuple[int, ...], fill: int, stream: bool = False) -> list[int]:
    """``t`` lifted to rank 3: leading ``fill``s, or at rank 2 on
    ``swc_stream`` ``fill`` inserted as y, so the stream axis stays the
    kernel's z."""
    if stream and len(t) == 2:
        return [t[0], fill, t[1]]
    return [fill] * (3 - len(t)) + list(t)


def _padded(plan: StencilPlan) -> tuple[int, ...]:
    return tuple(n + 2 * h for n, h in zip(plan.interior, plan.halo))


def _aux_shape(plan: StencilPlan) -> tuple[int, ...]:
    """(n_aux, *interior), widened by r(S-1) per side at depth S > 1."""
    return (plan.n_aux,) + tuple(
        n + 2 * r * (plan.fuse_steps - 1)
        for n, r in zip(plan.interior, plan.radii)
    )


def geometry(plan: StencilPlan, slots: list[int]) -> np.ndarray:
    """The kernel's int geometry array (``GeomIndex`` of
    ``csrc/stencil_common.cuh``): ranks 1/2 lifted to rank 3 with unit
    extents and zero radii — leading, or on ``swc_stream`` at rank 2 as
    y, the stream axis (y) becoming the kernel's z. The tap table's
    rank-2 offsets (0, dy, dx) need no change for that: with a y extent
    of 1 they land on the linear offset of (dy, 0, dx)."""
    st = plan.stream_axis is not None
    g = [plan.n_f, plan.n_out, plan.n_aux]
    g += _rank3(plan.interior, 1, st) + _rank3(_padded(plan), 1, st)
    g += _rank3(plan.radii, 0, st) + _rank3(plan.block, 1, st)
    g += [plan.unroll, plan.n_ops, plan.n_taps, len(slots)]
    g += [plan.fuse_steps, plan.stage_buffers, plan.threads, plan.segments]
    tc = plan.strategy == "tc"
    g += [plan.batch, tc_coef_len(plan.radii) if tc else 0]
    g += slots + [0] * (MAX_SLOTS - len(slots))
    # Depth 1: tiles per step and tc's table words (persistent), outputs
    # per thread (swc, and swc_stream on its ring body, which a nonzero
    # count selects); 0 elsewhere.
    if plan.persistent:
        g += [plan.tiles_per_step, plan.tc_table_words,
              plan.outputs_per_thread if plan.swc_depth1 else 0]
    else:
        g += [0, 0, plan.outputs_per_thread if plan.stream_depth1 else 0]
    return np.asarray(g, dtype=np.int32)


def _check(f_padded, ops, phi, plan, aux, taps) -> None:
    rank = plan.rank
    if ops.ndim != rank or ops.radius_per_axis() != plan.radii:
        raise ValueError("operator set does not match the plan")
    if (plan.n_ops, plan.n_taps) != (ops.n_s, ops.taps_per_point):
        raise ValueError("plan was made for another tap table")
    lead = (plan.batch,) if is_ensemble(plan.rank, f_padded.ndim) else ()
    if not lead and plan.batch > 1:
        raise ValueError(
            f"plan serves {plan.batch} members: the operand must be "
            f"(batch, n_f, *padded), got shape {tuple(f_padded.shape)}"
        )
    padded = _padded(plan)
    if tuple(f_padded.shape) != lead + (plan.n_f,) + padded:
        raise ValueError(
            f"f_padded shape {tuple(f_padded.shape)} != plan's "
            f"{lead + (plan.n_f,) + padded}"
        )
    if dtype_name(f_padded.dtype) != plan.dtype:
        raise ValueError(f"dtype {f_padded.dtype} != plan's {plan.dtype}")
    has_aux = aux is not None
    if has_aux != bool(plan.n_aux) or has_aux != phi.needs_aux:
        raise ValueError("aux operand does not match plan.n_aux and φ")
    if aux is not None:
        if tuple(aux.shape) != lead + _aux_shape(plan):
            raise ValueError(
                f"aux shape {tuple(aux.shape)} != {lead + _aux_shape(plan)}"
            )
        if aux.dtype != f_padded.dtype or aux.device != f_padded.device:
            raise ValueError("aux must match f_padded's dtype and device")
    if phi.n_out(plan.n_f) != plan.n_out:
        raise ValueError(
            f"{phi.kind} writes {phi.n_out(plan.n_f)} rows, plan has "
            f"n_out={plan.n_out}"
        )
    if phi.kind != "select" and (plan.n_f, plan.n_aux) not in (
        (8, 0), (8, 8)
    ):
        raise ValueError(f"{phi.kind} needs 8 fields (and 8 aux rows)")
    if phi.kind != "select" and plan.dtype == "bfloat16":
        raise NotImplementedError(
            f"{phi.kind} in bfloat16 is not ported yet: ROADMAP B4b (the "
            "MHD φ in bfloat16)"
        )
    if (
        plan.strategy == "tc" or plan.swc_depth1 or plan.stream_depth1
    ) and plan.n_slots != len(phi.operators):
        _slots_mismatch(plan, phi)  # the kernel's layout follows them
    if plan.threads > phi.max_threads and not (
        plan.persistent or plan.stream_depth1
    ):
        raise ValueError(
            f"{phi.kind} keeps its derivative values in registers and "
            f"takes tiles of at most {phi.max_threads} points; tile "
            f"{plan.block} has {plan.threads}"
        )
    missing = [n for n in phi.operators if n not in ops.names]
    if missing:
        raise ValueError(f"φ reads operators {missing} not in the set")
    if taps is not None:
        if any(t.device != f_padded.device for t in taps):
            raise ValueError(
                f"the tap table is on {taps[0].device}, the fields on "
                f"{f_padded.device}: move the op with .to(device)"
            )
        if taps[1].dtype != torch.float64:
            raise ValueError(
                "tap coefficients must stay float64 (the kernel casts "
                "them to the field dtype); move an op with .to(device) "
                "only"
            )


def _slots_mismatch(plan: StencilPlan, phi: DevicePhi) -> None:
    raise ValueError(
        f"{plan.strategy} plan made for {plan.n_slots} operator slot(s), φ "
        f"reads {len(phi.operators)}"
    )


def fused_stencil_swc(
    f_padded: torch.Tensor,
    ops: OperatorSet,
    phi: DevicePhi | tuple[DevicePhi, ...],
    plan: StencilPlan,
    *,
    aux: torch.Tensor | None = None,
    taps: TapTable | None = None,
) -> torch.Tensor:
    """Fused φ(A·B) for one ``swc``, ``swc_stream`` or ``tc`` plan of
    depth S = ``plan.fuse_steps``:
    (n_f, *(n + 2rS)) → (n_out, *n), S sweeps per launch; an ensemble
    (batch, n_f, *(n + 2rS)) → (batch, n_out, *n) in one launch too, aux
    then carrying the same leading axis.

    ``phi`` is one :class:`DevicePhi` or, at depth S, a sequence of S
    (one per sweep, :func:`~repro_torch.kernels.phi.phi_sequence`).
    ``aux`` (n_aux, *(n + 2r(S-1))) is forwarded to φ (the MHD fused RK
    axpy); at depth > 1 its rows are carried from sweep to sweep.
    ``taps`` is the operator set's :func:`tap_table` on ``f_padded``'s
    device (a module's buffers; ``tc`` ignores it and takes its
    :func:`tc_table`); ``None`` uses the per-device cache.
    Each kernel launch (one per call, whatever the batch) adds one to
    ``fused_stencil_swc.launches``, to
    ``fused_stencil_swc.launches_by_depth[S]`` and to
    ``fused_stencil_swc.launches_by_kernel[kernel_name(plan)]``.
    """
    phis = phi_sequence(phi, plan.fuse_steps)
    _check(f_padded, ops, phis[0], plan, aux, taps)
    batched = is_ensemble(plan.rank, f_padded.ndim)
    if f_padded.device.type == "cpu":
        tc = plan.strategy == "tc"
        if plan.fuse_steps == 1:
            fn = ref.fused_stencil_batched if batched else ref.fused_stencil
            return fn(f_padded, ops, phis[0].torch_fn, aux=aux, tc=tc)
        fn = (
            ref.fused_stencil_steps_batched if batched
            else ref.fused_stencil_steps
        )
        return fn(
            f_padded, ops, [p.torch_fn for p in phis], plan.fuse_steps,
            aux=aux, tc=tc,
        )
    if f_padded.device.type != "cuda":
        raise ValueError(f"unsupported device {f_padded.device}")
    if not f_padded.is_contiguous() or (
        aux is not None and not aux.is_contiguous()
    ):
        raise ValueError("f_padded and aux must be contiguous")
    if plan.strategy == "tc":
        taps = device_tc_table(ops, plan.dtype, f_padded.device)
        if plan.tc_depth1 and taps[3].numel() != plan.tc_table_words:
            raise ValueError(
                f"tc plan made for a table of {plan.tc_table_words} words, "
                f"the operator set's has {taps[3].numel()}"
            )
    elif taps is None:
        taps = device_tap_table(ops, f_padded.device)
    slots = [ops.names.index(n) for n in phis[0].operators]
    geom = geometry(plan, slots)
    params = device_params(tuple(p.params for p in phis), f_padded.device)
    out = torch.empty(
        (plan.batch,) * batched + (plan.n_out,) + plan.interior,
        dtype=f_padded.dtype,
        device=f_padded.device,
    )
    name = kernel_name(plan)
    lib = _lib(name)
    err = getattr(lib, f"repro_{name}")(
        f_padded.data_ptr(),
        None if aux is None else aux.data_ptr(),
        out.data_ptr(),
        *(t.data_ptr() for t in taps),
        _int_ptr(geom),
        params.data_ptr(), params.shape[1], phis[0].kind_id,
        DTYPE_CODES[plan.dtype],
        f_padded.device.index or 0,
        torch.cuda.current_stream(f_padded.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.repro_cuda_error_string(err).decode()})"
        )
    fused_stencil_swc.launches += 1
    fused_stencil_swc.launches_by_depth[plan.fuse_steps] += 1
    fused_stencil_swc.launches_by_kernel[name] += 1
    return out


fused_stencil_swc.launches = 0
fused_stencil_swc.launches_by_depth = collections.Counter()
fused_stencil_swc.launches_by_kernel = collections.Counter()


def reset_launch_counts() -> None:
    """Zero ``fused_stencil_swc.launches`` and its per-depth and
    per-kernel counts."""
    fused_stencil_swc.launches = 0
    fused_stencil_swc.launches_by_depth.clear()
    fused_stencil_swc.launches_by_kernel.clear()
