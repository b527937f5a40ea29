"""Mirrors of the port's CUDA bodies, one per body, for the auditor.

The reference shadow-runs its Python kernel bodies. The port's bodies are
CUDA, so each is mirrored here: its geometry from ``kernels/plan.py``'s
own mirrors where they exist (``swc_step``, ``stream_ring``,
``stream_schedule``, ``stream_tap_rows``, ``walk_ring``,
``walk_schedule``, ``tc_step``, ``sweep_regions``; every one resolved
through the module at call time, so the mutation harness's seeded
defects are what runs), otherwise from the ``.cuh`` file's own
``__host__ __device__`` geometry, cited by line. Each mirror drives the
access events of one class of tile or column at a time through
:mod:`repro_torch.analysis.shadow`: the 16-byte copies of its windows
(granule rule, landing, disjoint rows), the shared reads of its taps
(inside the window box, from the slot that holds the plane they name,
landed), the ring protocol (copies, commits, waits, barriers) and its
stores (each output of a step or column exactly once). The whole grid
is never enumerated: 512³ on (8, 16, 32) has 32768 tiles. The tile
classes are the grid's corners (first and last member, tile or column
on each axis, first and last field or segment) at two alignments of the
input (its first element on a 16-byte boundary and one element past
it), and the persistent walks are proved for every grid.

Each mirror returns a :class:`BodyRun`: the body's name, the classes it
proved, the shared bytes its layout measures (counted from the buffers
it staged into, the tap table and φ's inputs, independently of
``StencilPlan.smem_bytes``) and the fields of the body's ``Shape`` /
``Ring`` / ``Layout`` structs, which ``chip_smoke.py`` phase 3 (audit)
holds field by field to the library's ``repro_<name>_layout`` export.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np

from repro_torch.analysis import shadow
from repro_torch.analysis.findings import AuditError
from repro_torch.kernels import plan as plan_mod

SMS = 132  # an H100 SXM's SMs: the persistent grids sampled below
BASES = (0, 1)  # the input's first element: on a 16-byte boundary, one past
MHD_BATCH = 128  # temporal_walk_body.cuh:104 (plan.WALK_MHD_BATCH)
TC_SEG = 8  # tc_body.cuh SEG (plan.TC_SEGMENT)


@dataclasses.dataclass
class BodyRun:
    body: str
    classes: int
    measured: int  # shared bytes of one block, counted by the mirror
    layout: dict[str, int]


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tap_bytes(item: int) -> int:
    return 2 * max(item, 4)  # Tap<T>: the coefficient beside an int32


# ---------------------------------------------------------------------------
# Hooks the mutation harness replaces (each mirrors one line of CUDA)
# ---------------------------------------------------------------------------


def tap_offsets(ops, rank: int, lift_y: bool = False) -> np.ndarray:
    """The distinct (dz, dy, dx) of the taps (``emit.tap_table``'s rows:
    rank 1 and 2 offsets padded with leading zeros); with ``lift_y`` (rank
    2 walked along y, lifted to (Y, 1, X)) the kernel reads (0, dy, dx) as
    (dy, 0, dx) (``stream_body.cuh:176-181``)."""
    return _tap_offsets(ops, rank, lift_y)


@functools.lru_cache(maxsize=256)
def _tap_offsets(ops, rank: int, lift_y: bool) -> np.ndarray:
    rows = []
    for spec in ops.ops:
        for off in spec.offsets:
            o = (0,) * (3 - rank) + tuple(int(v) for v in off)
            if lift_y:
                o = (o[0] + o[1], 0, o[2])
            rows.append(o)
    return np.unique(np.asarray(rows, np.int64).reshape(-1, 3), axis=0)


def ring_slot(c: int, d: int, per: int) -> int:
    """The slot of the plane ``d`` planes from slot ``c`` in a ring of
    ``per`` slots (``stream_body.cuh:181-183``, the walk's tap rows
    ``temporal_walk_body.cuh:435-437``)."""
    return (c + d) % per


def ring_ahead(n_buf: int) -> int:
    """Units a ring of ``n_buf`` buffers fetches before the first is read
    (``swc_body.cuh:297``: n_buf − 1)."""
    return n_buf - 1


def thread_outputs(u: int) -> range:
    """The outputs i < U a thread stores per round (``swc_body.cuh:332``)."""
    return range(u)


def walker_advance(nx: int, ny: int, nz: int, grid: int) -> int:
    """Items one ``Walker::next`` step advances (``persistent.cuh:60-82``):
    the digits of ``at(gridDim.x)``, added digit by digit with one carry
    each, recombined."""
    i = grid
    sx, i = i % nx, i // nx
    sy, i = i % ny, i // ny
    sz, sm = i % nz, i // nz
    if not (0 <= sx < nx and 0 <= sy < ny and 0 <= sz < nz):
        raise AuditError("coverage", "walker digits out of their radix")
    return ((sm * nz + sz) * ny + sy) * nx + sx


# ---------------------------------------------------------------------------
# Shared geometry
# ---------------------------------------------------------------------------


def lifted(plan, t: Sequence[int], fill: int) -> tuple[int, int, int]:
    """``t`` at rank 3 as the kernel sees it (``emit._rank3``): leading
    fill, or at rank 2 on ``swc_stream`` and the walks (Y, 1, X)."""
    if (plan.stream_axis is not None or plan.walk) and len(t) == 2:
        return (t[0], fill, t[1])
    return (fill,) * (3 - len(t)) + tuple(t)


def padded3(plan) -> tuple[int, int, int]:
    return lifted(plan, tuple(n + 2 * h for n, h in
                              zip(plan.interior, plan.halo)), 1)


def itemsize(plan) -> int:
    return plan_mod.ITEMSIZE[plan.dtype]


def _corner_items(dims: Sequence[int]) -> list[tuple[int, ...]]:
    """The grid's corners: all-first, each axis alone at its last, and
    all-last (digits slowest first)."""
    first = tuple(0 for _ in dims)
    out = [first]
    for a, n in enumerate(dims):
        if n > 1:
            out.append(tuple(n - 1 if b == a else 0
                             for b in range(len(dims))))
    out.append(tuple(n - 1 for n in dims))
    return list(dict.fromkeys(out))


def _prove_walk(items: int, nx: int, ny: int, nz: int, label: str) -> None:
    shadow.prove_persistent_walk(
        items, lambda g: walker_advance(nx, ny, nz, g), label,
        sample=(1, 2, SMS, 2 * SMS, items - 1, items))


def _check_taps(offs: np.ndarray, tile: Sequence[int], r: Sequence[int],
                window: Sequence[int], label: str) -> None:
    """Every tap of every point of a tile reads inside the window box:
    point (z, y, x) reads window point (z + rz + dz, ...)."""
    lo = np.asarray(r) + offs
    hi = lo + np.asarray(tile)
    bad = np.any((lo < 0) | (hi > np.asarray(window)), axis=1)
    if np.any(bad):
        d = tuple(int(v) for v in offs[int(np.argmax(bad))])
        box = tuple((ri + di, ri + di + t) for ri, di, t in zip(r, d, tile))
        shadow.check_box(box, window, f"{label}: tap {d}")


def _ring_protocol(n_buf: int, units: int, label: str) -> None:
    """The units ring of ``swc_body.cuh:292-322`` and ``tc_body.cuh``:
    unit u in buffer u mod n_buf, ``ring_ahead`` units issued first; each
    iteration waits (one group in flight with three buffers), takes a
    barrier, issues unit u + ahead and reads unit u."""
    blk = shadow.Block({"ring": n_buf})
    ahead = ring_ahead(n_buf)
    nxt = 0
    for _ in range(ahead):
        if nxt < units:
            blk.copy("ring", nxt % n_buf, nxt)
            nxt += 1
        blk.commit()
    for u in range(units):
        blk.wait(1 if n_buf == 3 else 0)
        blk.barrier()
        if u + ahead < units:
            blk.copy("ring", (u + ahead) % n_buf, u + ahead)
        blk.commit()
        blk.read("ring", u % n_buf, u, f"{label}: unit {u}")


# ---------------------------------------------------------------------------
# B1 / B5: the depth-1 swc body (swc_body.cuh)
# ---------------------------------------------------------------------------


def swc_body(plan, ops) -> BodyRun:
    label = "swc_body"
    step = plan.swc_step
    item = itemsize(plan)
    V = 16 // item
    tz, ty, tx = step.extent
    wz, wy, wx = step.window
    pitch, plane = step.pitch, step.plane
    rz, ry, rx = lifted(plan, plan.radii, 0)
    pz, py, px = padded3(plan)
    nf, B = plan.n_f, plan.batch
    nz, ny, nx = (n // t for n, t in zip(lifted(plan, plan.interior, 1),
                                          (tz, ty, tx)))
    # swc_shape (swc_body.cuh:101-117): the buffer of one window.
    buf = _cdiv(V - 1 + (wz - 1) * plane + (wy - 1) * pitch + wx, V) * 16
    if (tz + 2 * rz, ty + 2 * ry, tx + 2 * rx) != (wz, wy, wx):
        raise AuditError("bounds", f"{label}: window {step.window} is not "
                         "the step widened by its radii")
    numel = B * nf * pz * py * px
    zz, yy = np.meshgrid(np.arange(wz), np.arange(wy), indexing="ij")
    zz, yy = zz.ravel(), yy.ravel()
    classes = 0
    for m, iz, iy, ix in _corner_items((B, nz, ny, nx)):
        for k in dict.fromkeys((0, nf - 1)):
            origin = ((m * nf + k) * pz + iz * tz) * py * px \
                + iy * ty * px + ix * tx
            G = origin + zz * py * px + yy * px
            shadow.check_global(G, wx, numel, label)
            for base in BASES:
                s0 = (base + origin) % V
                shadow.congruent_rows(G, s0 + zz * plane + yy * pitch, wx, V,
                                      base, buf // item,
                                      f"{label} step {(m, iz, iy, ix)}")
                classes += 1
    _check_taps(tap_offsets(ops, plan.rank), (tz, ty, tx), (rz, ry, rx),
                (wz, wy, wx), label)
    # The rounds of a step (swc_body.cuh:323-336): thread tid's outputs
    # p0 + tid + i nthr, i < U.
    nthr, U = plan.threads, plan.outputs_per_thread
    points = tz * ty * tx
    p0 = np.arange(0, points, nthr * U)[:, None, None]
    p = (p0 + np.arange(nthr)[None, :, None]
         + np.asarray(list(thread_outputs(U)))[None, None, :] * nthr).ravel()
    shadow.exactly_once(p[p < points], points, f"{label}: a step's stores")
    for units in range(1, 2 * plan.stage_buffers + 3):
        _ring_protocol(plan.stage_buffers, units, label)
    _prove_walk(plan.walk_items, nx, ny, nz, label)
    # swc_layout (swc_body.cuh:127-143).
    taps = plan.stage_buffers * buf
    starts = taps + ops.taps_per_point * _tap_bytes(item)
    total = starts + (ops.n_s + 1) * 4
    sums = total
    if plan.n_slots > 1:
        sums = _r16(total)
        total = sums + plan.n_slots * nf * points * item
    fields = dict(tz=tz, ty=ty, tx=tx, wz=wz, wy=wy, wx=wx, pitch=pitch,
                  plane=plane, points=points, buf=buf, taps=taps,
                  starts=starts, sums=sums, total=total)
    return BodyRun(label, classes, total, fields)


# ---------------------------------------------------------------------------
# B3 at depth 1: the stream ring body (stream_body.cuh)
# ---------------------------------------------------------------------------


def _column_classes(plan, ny: int, nx: int) -> list[tuple[int, ...]]:
    return _corner_items((plan.batch, plan.segments, ny, nx))


def stream_body(plan, ops) -> BodyRun:
    label = "stream_body"
    ring = plan.stream_ring
    item = itemsize(plan)
    V = 16 // item
    tz, ty, tx = ring.chunk
    wy, wx = ring.window
    P, lead, pitch, plane = ring.period, ring.lead, ring.pitch, ring.plane
    rz, ry, rx = lifted(plan, plan.radii, 0)
    pz, py, px = padded3(plan)
    nf, B = plan.n_f, plan.batch
    psz, pfield = py * px, pz * py * px
    ny, nx = py - 2 * ry, px - 2 * rx
    ny, nx = ny // ty, nx // tx
    if (P * plane) % V or (ring.field_stride - pfield) % V:
        raise AuditError("bounds", f"{label}: the ring's period or field "
                         "stride breaks the 16-byte congruence")
    if P < plan.stage_buffers * tz + lead:
        raise AuditError("bounds", f"{label}: {P} plane slots hold fewer "
                         f"than {plan.stage_buffers} chunks and the lead")
    chunks = plan.n_chunks // plan.segments
    fetches = {ev[1]: ev[2] for ev in plan_mod.stream_schedule(plan)
               if ev[0] == "fetch"}
    reads = [ev for ev in plan_mod.stream_schedule(plan) if ev[0] == "read"]
    limit = nf * ring.field_stride
    numel = B * nf * pfield
    classes = 0
    pick = sorted({0, len(fetches) // 2, len(fetches) - 1} & set(fetches))
    for m, seg, iy, ix in _column_classes(plan, ny, nx):
        col = m * nf * pfield + seg * chunks * tz * psz + iy * ty * px \
            + ix * tx
        for i in pick:
            planes = np.asarray([j for j, _ in fetches[i]], np.int64)
            slots = np.asarray([s for _, s in fetches[i]], np.int64)
            jj, yy = np.meshgrid(np.arange(planes.size), np.arange(wy),
                                 indexing="ij")
            jj, yy = jj.ravel(), yy.ravel()
            for k in dict.fromkeys((0, nf - 1)):
                G = col + k * pfield + planes[jj] * psz + yy * px
                shadow.check_global(G, wx, numel, label)
                for base in BASES:
                    s0 = (base + col) % V
                    Bk = k * ring.field_stride + s0 + slots[jj] * plane \
                        + yy * pitch
                    shadow.congruent_rows(G, Bk, wx, V, base, limit,
                                          f"{label} column {(m, seg, iy, ix)}"
                                          f" fetch {i}")
                    classes += 1
    # The tap rows (stream_body.cuh:170-187), one per plane slot.
    lift = ry == 0
    offs = tap_offsets(ops, plan.rank, lift_y=lift)
    rows = plan_mod.stream_tap_rows(ring, plan.radii,
                                    [tuple(o) for o in offs])
    q = np.arange(P)[:, None]
    slots = np.asarray([[ring_slot(c, int(dz), P) for dz in offs[:, 0]]
                        for c in range(P)], np.int64)
    want = (slots - q) * plane + offs[:, 1] * pitch + offs[:, 2]
    got = np.asarray(rows, np.int64).reshape(want.shape)
    if np.any(got != want):
        c, t = np.argwhere(got != want)[0]
        raise AuditError("bounds", f"{label}: tap row {c} offset "
                         f"{int(got[c, t])} of tap {tuple(offs[t])}, the "
                         f"ring puts it at {int(want[c, t])}")
    _check_taps(offs, (tz, ty, tx), (rz, ry, rx), (tz + lead, wy, wx),
                label)
    # The chunk loop (stream_body.cuh:258-345).
    select = plan.n_slots == 1
    NB = plan.stage_buffers
    ahead = NB - 1 if select else NB
    blk = shadow.Block({"ring": P})

    def fetch(i):
        for j, s in fetches.get(i, ()):
            blk.copy("ring", s, j)

    for i in range(ahead):
        if i < chunks:
            fetch(i)
        blk.commit()
    for i in range(chunks):
        blk.wait(ahead - 1)
        blk.barrier()
        if select:
            if i + NB - 1 < chunks:
                fetch(i + NB - 1)
            blk.commit()
        _, ci, q0 = reads[i]
        for j in range(tz + lead):
            blk.read("ring", ring_slot(q0, j, P), ci * tz + j,
                     f"{label}: chunk {ci}")
        if not select:
            blk.barrier()
            if i + NB < chunks:
                fetch(i + NB)
            blk.commit()
    # Stores: warp w's runs of 32 U points, lane l its l + 32 u.
    nthr, U = plan.threads, plan.outputs_per_thread
    points = tz * ty * tx
    if select:
        run = (np.arange(nthr) >> 5) * 32 * U + (np.arange(nthr) & 31)
        p = (np.arange(0, points, nthr * U)[:, None, None] + run[None, :, None]
             + 32 * np.asarray(list(thread_outputs(U)))[None, None, :]).ravel()
    else:
        p = np.arange(0, points, nthr)[:, None] + np.arange(nthr)[None, :]
        p = p.ravel()
    shadow.exactly_once(p[p < points], points, f"{label}: a chunk's stores")
    if plan.n_chunks % plan.segments:
        raise AuditError("coverage", f"{label}: segments do not divide the "
                         "chunks")
    # ring_layout (stream_body.cuh:136-152).
    taps = _r16(nf * ring.field_stride * item)
    starts = taps + P * ops.taps_per_point * _tap_bytes(item)
    total = starts + (ops.n_s + 1) * 4
    sums = total
    if plan.n_slots > 1:
        sums = _r16(total)
        total = sums + plan.n_slots * nf * points * item
    fields = dict(tz=tz, ty=ty, tx=tx, wy=wy, wx=wx, lead=lead, pitch=pitch,
                  plane=plane, period=P, fstride=ring.field_stride, taps=taps,
                  starts=starts, sums=sums, total=total)
    return BodyRun(label, classes, total, fields)


# ---------------------------------------------------------------------------
# B3 at depth 1 (f64 MHD RHS): the one-buffer body (fused_stencil_stream.cu)
# ---------------------------------------------------------------------------


def stream_buffer(plan, ops) -> BodyRun:
    label = "stream_buffer"
    item = itemsize(plan)
    tz, ty, tx = lifted(plan, plan.block, 1)
    rz, ry, rx = lifted(plan, plan.radii, 0)
    pz, py, px = padded3(plan)
    nf, B = plan.n_f, plan.batch
    carried = 2 * rz
    wz, wy, wx = tz + carried, ty + 2 * ry, tx + 2 * rx
    ny, nx = (py - 2 * ry) // ty, (px - 2 * rx) // tx
    chunks = plan.n_chunks // plan.segments
    psz, pfield = py * px, pz * py * px
    numel = B * nf * pfield
    classes = 0
    yy = np.arange(wy)
    for m, seg, iy, ix in _column_classes(plan, ny, nx):
        col = m * nf * pfield + iy * ty * px + ix * tx
        first = seg * chunks
        for z0, nz_ in ((first * tz, carried),
                        ((first + chunks - 1) * tz + carried, tz)):
            zz, y2 = np.meshgrid(np.arange(nz_), yy, indexing="ij")
            G = col + (z0 + zz.ravel()) * psz + y2.ravel() * px
            shadow.check_global(G + (nf - 1) * pfield, wx, numel, label)
            shadow.element_rows((zz.ravel() * wy + y2.ravel()) * wx, wx,
                                wz * wy * wx, label)
            classes += 1
    _check_taps(tap_offsets(ops, plan.rank, lift_y=ry == 0), (tz, ty, tx),
                (rz, ry, rx), (wz, wy, wx), label)
    # The chunk loop (fused_stencil_stream.cu:186-233): work's planes
    # carry global labels, pf's the fresh planes.
    blk = shadow.Block({"work": wz, "pf": tz})
    first = 0
    for j in range(carried):
        blk.copy("work", j, first * tz + j)
    blk.commit()
    for j in range(tz):
        blk.copy("pf", j, first * tz + carried + j)
    blk.commit()
    for c in range(chunks):
        blk.wait(0)
        blk.barrier()
        for j in range(tz):
            blk.read("pf", j, c * tz + carried + j, f"{label}: land {c}")
            blk.store("work", carried + j, c * tz + carried + j)
        blk.barrier()
        if c + 1 < chunks:
            for j in range(tz):
                blk.copy("pf", j, (c + 1) * tz + carried + j)
        blk.commit()
        for j in range(wz):
            blk.read("work", j, c * tz + j, f"{label}: chunk {c}")
        blk.barrier()
        for b0 in range(0, carried, tz):
            for j in range(min(tz, carried - b0)):
                blk.read("work", b0 + j + tz, c * tz + b0 + j + tz,
                         f"{label}: carry {c}")
                blk.store("work", b0 + j, c * tz + b0 + j + tz)
            if b0 + tz < carried:
                blk.barrier()
    points = tz * ty * tx
    p = (np.arange(0, points, plan.threads)[:, None]
         + np.arange(plan.threads)[None, :]).ravel()
    shadow.exactly_once(p[p < points], points, f"{label}: a chunk's stores")
    # layout (fused_stencil_stream.cu:103-124).
    work = 0
    pf = _r16(nf * wz * wy * wx * item)
    taps = pf + _r16(nf * tz * wy * wx * item)
    starts = taps + ops.taps_per_point * _tap_bytes(item)
    total = starts + (ops.n_s + 1) * 4
    fields = dict(work=work, pf=pf, taps=taps, starts=starts, total=total)
    return BodyRun(label, classes, total, fields)


# ---------------------------------------------------------------------------
# B2 / B3 at depth > 1, B4's walk: the column walk
# (temporal_walk_body.cuh walk_columns, tc_walk_body.cuh)
# ---------------------------------------------------------------------------


def _walk_common(plan, ops, label: str) -> int:
    """The walk both bodies share: staging of the input ring per column
    class, the regions and the ring protocol of every sweep over one
    column segment, the stores of each sweep's planes and the persistent
    walk of the columns. Returns the column classes proved."""
    wr = plan.walk_ring
    inp = wr.inp
    item = itemsize(plan)
    V = 16 // item
    S = plan.fuse_steps
    tau, ty, tx = lifted(plan, plan.block, 1)
    rz, ry, rx = lifted(plan, plan.radii, 0)
    pz, py, px = padded3(plan)
    nf, B = plan.n_f, plan.batch
    P, Q, C = inp.period, wr.mid_slots, wr.carry_slots
    lead = inp.lead
    wy, wx = inp.window
    psz, pfield = py * px, pz * py * px
    ny, nx = (py - 2 * ry * S) // ty, (px - 2 * rx * S) // tx
    seg = plan.interior[0] // plan.segments
    # φ: sweep s's region is τ + 2r(S-1-s) across the walk, and its
    # source the next wider one (temporal_walk_body.cuh:149-152).
    for s, (ys, xs) in enumerate(wr.regions):
        want = (ty + 2 * ry * (S - 1 - s), tx + 2 * rx * (S - 1 - s))
        if (ys, xs) != want:
            raise AuditError("phi", f"{label}: sweep {s} region {(ys, xs)} "
                             f"!= the schedule's {want}")
        src = (wy, wx) if s == 0 else wr.regions[s - 1]
        shadow.check_box(((ry, ry + ys), (rx, rx + xs)), src,
                         f"{label}: sweep {s}'s centres in its source")
    if (wy, wx) != (ty + 2 * ry * S, tx + 2 * rx * S):
        raise AuditError("bounds", f"{label}: input window {(wy, wx)} is not "
                         "the tile widened by r S")
    if Q != tau + lead or C != tau + rz:
        raise AuditError("bounds", f"{label}: ring slots {Q}, {C} for a step "
                         f"of {tau} and lead {lead}")
    sched = plan_mod.walk_schedule(plan)
    fetches = {ev[1]: ev[2] for ev in sched if ev[0] == "fetch"}
    sweeps: dict[int, list] = {}
    for ev in sched:
        if ev[0] == "sweep":
            sweeps.setdefault(ev[1], []).append(ev[2:])
    steps = _cdiv(seg + lead * (S - 1), tau)
    # Staging of the input ring (walk_columns, :266-290).
    limit = nf * inp.field_stride
    numel = B * nf * pfield
    if (P * inp.plane) % V or (inp.field_stride - pfield) % V:
        raise AuditError("bounds", f"{label}: the input ring's period or "
                         "field stride breaks the 16-byte congruence")
    classes = 0
    pick = sorted({0, len(fetches) // 2, len(fetches) - 1} & set(fetches))
    for m, sg, iy, ix in _column_classes(plan, ny, nx):
        col = m * nf * pfield + sg * seg * psz + iy * ty * px + ix * tx
        for i in pick:
            planes = np.asarray([j for j, _ in fetches[i]], np.int64)
            slots = np.asarray([s for _, s in fetches[i]], np.int64)
            jj, yy = np.meshgrid(np.arange(planes.size), np.arange(wy),
                                 indexing="ij")
            jj, yy = jj.ravel(), yy.ravel()
            for k in dict.fromkeys((0, nf - 1)):
                G = col + k * pfield + planes[jj] * psz + yy * px
                shadow.check_global(G, wx, numel, label)
                for base in BASES:
                    s0 = (base + col) % V
                    Bk = k * inp.field_stride + s0 + slots[jj] * inp.plane \
                        + yy * inp.pitch
                    shadow.congruent_rows(G, Bk, wx, V, base, limit,
                                          f"{label} column {(m, sg, iy, ix)}"
                                          f" fetch {i}")
                    classes += 1
    # Taps across the walk: (dy, dx) inside each sweep's source window.
    offs = tap_offsets(ops, plan.rank, lift_y=ry == 0)
    for s, (ys, xs) in enumerate(wr.regions):
        src = (wy, wx) if s == 0 else wr.regions[s - 1]
        for _, dy, dx in offs:
            shadow.check_box(((ry + dy, ry + dy + ys), (rx + dx, rx + dx + xs)),
                             src, f"{label}: sweep {s} tap ({dy}, {dx})")
    dzs = sorted({int(o[0]) for o in offs} | {-rz, rz})
    # The protocol of one column segment (walk_columns, :292-338).
    rings = {"in": P}
    rings.update({f"mid{s}": Q for s in range(S - 1)})
    aux = bool(plan.n_aux)
    if aux:
        rings.update({f"carry{s}": C for s in range(S - 1)})
    blk = shadow.Block(rings)
    NB = plan.stage_buffers

    def fetch(i):
        for j, slot in fetches.get(i, ()) if i < steps else ():
            blk.copy("in", slot, j)

    done = [np.zeros(seg + lead * (S - 1 - s), np.int64) for s in range(S)]
    blk.barrier()
    for i in range(NB - 1 if NB > 1 else 1):
        fetch(i)
        blk.commit()
    for i in range(steps):
        blk.wait(0)
        blk.barrier()
        if NB > 1:
            fetch(i + NB - 1)
            blk.commit()
        for s in range(S):
            ev = [e for e in sweeps.get(i, ()) if e[0] == s]
            if ev:
                _, lo, hi = ev[0]
                done[s][lo:hi] += 1
                for z in range(lo, hi):
                    for dz in dzs:
                        if s == 0:
                            blk.read("in", ring_slot(z + rz, dz, P),
                                     z + rz + dz, f"{label}: sweep 0 plane "
                                     f"{z}")
                        else:
                            blk.read(f"mid{s - 1}", ring_slot(z + rz, dz, Q),
                                     (s - 1, z + rz + dz),
                                     f"{label}: sweep {s} plane {z}")
                    if aux and s > 0:
                        blk.read(f"carry{s - 1}", (z + rz) % C,
                                 (s - 1, z + rz), f"{label}: carry of sweep "
                                 f"{s} plane {z}")
                    if s < S - 1:
                        blk.store(f"mid{s}", z % Q, (s, z))
                        if aux:
                            blk.store(f"carry{s}", z % C, (s, z))
            if s < S - 1:
                blk.barrier()
                if s == 0 and NB == 1:
                    fetch(i + 1)
                    blk.commit()
    for s in range(S):
        if np.any(done[s] != 1):
            z = int(np.argmax(done[s] != 1))
            raise AuditError("coverage", f"{label}: sweep {s} computes plane "
                             f"{z} of {done[s].size} {int(done[s][z])} times")
    _prove_walk(plan.walk_items, nx, ny, plan.segments, label)
    return classes


def _walk_shape(plan) -> dict[str, int]:
    """The fields of ``walk_shape`` (``temporal_walk_body.cuh:121-146``)."""
    wr = plan.walk_ring
    inp = wr.inp
    tau, ty, tx = lifted(plan, plan.block, 1)
    return dict(tau=tau, ty=ty, tx=tx, wy=inp.window[0], wx=inp.window[1],
                lead=inp.lead, pitch=inp.pitch, plane=inp.plane,
                period=inp.period, fstride=inp.field_stride, q=wr.mid_slots,
                cq=wr.carry_slots, seg=plan.interior[0] // plan.segments)


def walk_body(plan, ops) -> BodyRun:
    """The select and MHD walk of ``temporal_walk_body.cuh`` (B2 at depth >
    1, and ``swc_stream``'s walk)."""
    label = "temporal_walk_body"
    classes = _walk_common(plan, ops, label)
    wr = plan.walk_ring
    inp = wr.inp
    item = itemsize(plan)
    S = plan.fuse_steps
    nthr = plan.threads
    select = plan.n_slots == 1 and not plan.n_aux
    for s, (ys, xs) in enumerate(wr.regions):
        pts = ys * xs
        if select:
            U = plan.outputs_per_thread
            R = _cdiv(pts, 32 * U)
            p = (np.arange(R)[:, None, None] * 32 * U
                 + np.arange(32)[None, :, None]
                 + 32 * np.asarray(list(thread_outputs(U)))[None, None, :])
            p = p.ravel()
            shadow.exactly_once(p[p < pts], pts, f"{label}: sweep {s}'s "
                                "plane stores")
        else:
            total = pts * plan.block[0]
            p = np.concatenate([np.arange(p0, min(p0 + MHD_BATCH, total))
                                for p0 in range(0, total, MHD_BATCH)])
            shadow.exactly_once(p, total, f"{label}: sweep {s}'s batches")
    if nthr % 32 or nthr > 512:
        raise AuditError("bounds", f"{label}: {nthr} threads")
    # walk_layout (temporal_walk_body.cuh:180-201).
    mid = _r16(plan.n_f * inp.field_stride * item)
    off = mid + sum(wr.mid_bytes)
    carry = off
    off += sum(wr.carry_bytes)
    div = off
    taps = div + S * 16
    rows = inp.period + (S - 1) * wr.mid_slots
    total = taps + rows * ops.taps_per_point * _tap_bytes(item)
    sums = total
    if plan.n_slots > 1:
        sums = _r16(total)
        total = sums + plan.n_slots * plan.n_f * MHD_BATCH * item
    fields = dict(_walk_shape(plan), mid=mid, carry=carry, div=div,
                  taps=taps, sums=sums, total=total)
    return BodyRun(label, classes, total, fields)


def tc_walk_body(plan, ops) -> BodyRun:
    """B4 at depth > 1 (``tc_walk_body.cuh``): the shared walk, and each
    sweep's patches with their masked loads (``contract``, :146-330): a
    load passes its mask only inside the source plane (rows < wy + 2ry,
    columns < wx + 2rx), and every load a live output's band needs
    passes it."""
    label = "tc_walk_body"
    classes = _walk_common(plan, ops, label)
    wr = plan.walk_ring
    inp = wr.inp
    rows = plan_mod.TC_MMA_ROWS[plan.dtype]
    _, ry, rx = lifted(plan, plan.radii, 0)
    for s, (ys, xs) in enumerate(wr.regions):
        line, ppp = plan_mod.tc_walk_patches(plan, s)
        swy, swx = ys + 2 * ry, xs + 2 * rx
        segx = _cdiv(xs, TC_SEG)
        pidx = np.arange(ppp)
        m = np.arange(rows)
        n = np.arange(TC_SEG)
        if line:  # lines are row segments: line l = y segx + strip
            li = pidx[:, None] * rows + m[None, :]
            y = li // segx
            x0 = (li % segx) * TC_SEG
        else:
            y = (pidx // segx)[:, None] * rows + m[None, :]
            x0 = np.broadcast_to(((pidx % segx) * TC_SEG)[:, None], y.shape)
        y = np.broadcast_to(y[..., None], y.shape + (TC_SEG,))
        x = x0[..., None] + n
        live = (y < ys) & (x < xs)
        out = (y * xs + x)[live]
        shadow.exactly_once(out, ys * xs, f"{label}: sweep {s}'s patches")
        # Needed loads of live outputs: rows y + ry + j, columns x + rx + j
        # for |j| <= r, inside the source plane.
        for j in (-ry, ry):
            bad = ((y + ry + j) < 0) | ((y + ry + j) >= swy)
            if np.any(bad & live):
                raise AuditError("bounds", f"{label}: sweep {s} row tap {j} "
                                 "leaves the source plane")
        for j in (-rx, rx):
            bad = ((x + rx + j) < 0) | ((x + rx + j) >= swx)
            if np.any(bad & live):
                raise AuditError("bounds", f"{label}: sweep {s} column tap "
                                 f"{j} leaves the source plane")
    item = itemsize(plan)
    S = plan.fuse_steps
    mid = _r16(plan.n_f * inp.field_stride * item)
    carry = mid + sum(wr.mid_bytes)
    div = carry + sum(wr.carry_bytes)
    table = div + S * 16
    sums = table + _r16(4 * plan.tc_table_words)
    total = sums
    if plan.n_slots > 1:
        total += (4 * plan.n_slots * plan.n_f * plan_mod.TC_WALK_MHD_PATCHES
                  * plan_mod.TC_MMA_ROWS[plan.dtype] * plan_mod.TC_SEGMENT)
    fields = dict(_walk_shape(plan), mid=mid, carry=carry, div=div,
                  table=table, sums=sums, total=total)
    return BodyRun(label, classes, total, fields)


# ---------------------------------------------------------------------------
# B4 at depth 1: the tc body (tc_body.cuh)
# ---------------------------------------------------------------------------


def tc_body(plan, ops) -> BodyRun:
    label = "tc_body"
    step = plan.tc_step
    item = itemsize(plan)
    V = 16 // item
    tz, ty, tx = step.extent
    wz, wy, wx = step.window
    wyp, pitch, rows = step.rows_padded, step.pitch, step.rows
    rz, ry, rx = lifted(plan, plan.radii, 0)
    pz, py, px = padded3(plan)
    nf, B = plan.n_f, plan.batch
    nz, ny, nx = (n // t for n, t in zip(lifted(plan, plan.interior, 1),
                                          (tz, ty, tx)))
    buf_el = step.buffer_bytes // item
    if (tz + 2 * rz, ty + 2 * ry, tx + 2 * rx) != (wz, wy, wx):
        raise AuditError("bounds", f"{label}: window {step.window} is not "
                         "the step widened by its radii")
    numel = B * nf * pz * py * px
    zz, yy = np.meshgrid(np.arange(wz), np.arange(wy), indexing="ij")
    zz, yy = zz.ravel(), yy.ravel()
    classes = 0
    for m, iz, iy, ix in _corner_items((B, nz, ny, nx)):
        for k in dict.fromkeys((0, nf - 1)):
            origin = ((m * nf + k) * pz + iz * tz) * py * px \
                + iy * ty * px + ix * tx
            G = origin + zz * py * px + yy * px
            shadow.check_global(G, wx, numel, label)
            for base in BASES:
                shadow.shifted_rows(G, (zz * wyp + yy) * pitch, wx, V, base,
                                    pitch, buf_el,
                                    f"{label} step {(m, iz, iy, ix)}")
                classes += 1
    # The patches (tc_body.cuh:406-425): every output of a step in one
    # patch lane once; the reads of each group inside the buffer's rows.
    kx = plan_mod.tc_k_extent(rx, plan.dtype, "x")
    ky = plan_mod.tc_k_extent(ry, plan.dtype, "y")
    pidx = np.arange(step.patches)
    m_ = np.arange(rows)
    n_ = np.arange(TC_SEG)
    if step.line1d:
        z = np.zeros((step.patches, rows), np.int64)
        y = z.copy()
        x0 = pidx[:, None] * rows * TC_SEG + m_[None, :] * TC_SEG
        ylo = y
    else:
        segy, segx = _cdiv(ty, rows), _cdiv(tx, TC_SEG)
        t = pidx // segx
        z = np.broadcast_to((t // segy)[:, None], (step.patches, rows))
        ylo = ((t % segy) * rows)[:, None]
        y = ylo + m_[None, :]
        x0 = np.broadcast_to(((pidx % segx) * TC_SEG)[:, None], y.shape)
    x = x0[..., None] + n_
    zb = np.broadcast_to(z[..., None], x.shape)
    yb = np.broadcast_to(y[..., None], x.shape)
    live = (yb < ty) & (x < tx)
    out = ((zb * ty + yb) * tx + x)[live]
    shadow.exactly_once(out, tz * ty * tx, f"{label}: a step's patches")
    # Reads: x contraction columns x0 .. x0 + kx, lone taps and the z arm
    # at x + rx + dx; y contraction rows ylo .. ylo + ky; all inside a row
    # of pitch less the largest shift, and rows < wyp.
    if int(x0.max()) + kx > pitch - (V - 1) or \
            int(x.max()) + 2 * rx + 1 > pitch - (V - 1):
        raise AuditError("bounds", f"{label}: a contraction reads past its "
                         f"buffer row of {pitch}")
    if not step.line1d and int(np.max(ylo)) + ky > wyp:
        raise AuditError("bounds", f"{label}: the y contraction reads row "
                         f"{int(np.max(ylo)) + ky} of {wyp}")
    if int(z.max()) + 2 * rz >= wz or (not step.line1d and
                                        int(y.max()) + 2 * ry >= wyp):
        raise AuditError("bounds", f"{label}: a tap's plane or row leaves "
                         "the buffer")
    _check_taps(tap_offsets(ops, plan.rank), (tz, ty, tx), (rz, ry, rx),
                (wz, wy, wx), label)
    for units in range(1, 2 * plan.stage_buffers + 3):
        _ring_protocol(plan.stage_buffers, units, label)
    _prove_walk(plan.walk_items, nx, ny, nz, label)
    # tc_layout (tc_body.cuh:212-221).
    table = plan.stage_buffers * step.buffer_bytes
    sums = table + _r16(4 * plan.tc_table_words)
    total = sums
    if plan.n_slots > 1:
        total += 4 * plan.n_slots * nf * tz * ty * tx
    fields = dict(tz=tz, ty=ty, tx=tx, wz=wz, wy=wy, wx=wx, wyp=wyp,
                  pitch=pitch, patches=step.patches,
                  buf=step.buffer_bytes, table=table, sums=sums, total=total)
    return BodyRun(label, classes, total, fields)


# ---------------------------------------------------------------------------
# B2 one-tile (rank 1, f64 MHD; tc at rank 1): temporal_body.cuh
# ---------------------------------------------------------------------------


def temporal_body(plan, ops) -> BodyRun:
    label = "temporal_body"
    item = itemsize(plan)
    S = plan.fuse_steps
    tile = lifted(plan, plan.block, 1)
    r = lifted(plan, plan.radii, 0)
    pz, py, px = padded3(plan)
    nf, B = plan.n_f, plan.batch
    regions = [tuple(t + 2 * ri * (S - 1 - s) for t, ri in zip(tile, r))
               for s in range(S)]
    got = [lifted(plan, reg, 1) for reg in
           plan_mod.sweep_regions(plan.block, plan.radii, S)]
    for s in range(S):
        if got[s] != regions[s]:
            raise AuditError("phi", f"{label}: sweep {s} region {got[s]} != "
                             f"the schedule's {regions[s]}")
    window = tuple(t + 2 * ri * S for t, ri in zip(tile, r))
    grid = tuple(n // t for n, t in zip(lifted(plan, plan.interior, 1), tile))
    numel = B * nf * pz * py * px
    zz, yy = np.meshgrid(np.arange(window[0]), np.arange(window[1]),
                         indexing="ij")
    classes = 0
    for m, iz, iy, ix in _corner_items((B,) + grid):
        origin = (m * nf * pz + iz * tile[0]) * py * px + iy * tile[1] * px \
            + ix * tile[2]
        G = origin + zz.ravel() * py * px + yy.ravel() * px
        shadow.check_global(G + (nf - 1) * pz * py * px, window[2], numel,
                            label)
        classes += 1
    shadow.element_rows((zz.ravel() * window[1] + yy.ravel()) * window[2],
                        window[2], math.prod(window), label)
    offs = tap_offsets(ops, plan.rank)
    _check_taps(offs, got[0], r, window, f"{label}: sweep 0")
    if plan.n_slots > 1:
        # MHD: each batch of threads' points stages only the planes it
        # reads, [zlo, zhi + 2rz] of the window (temporal_body.cuh:173-
        # 187), into the same buffer.
        plane = got[0][1] * got[0][2]
        size = math.prod(got[0])
        for p0 in range(0, size, plan.threads):
            zlo, zhi = p0 // plane, (min(p0 + plan.threads, size) - 1) // plane
            sub = (zhi - zlo + 1 + 2 * r[0],) + window[1:]
            shadow.check_box(((zlo, zlo + sub[0]), (0, sub[1]), (0, sub[2])),
                             window, f"{label}: batch at {p0}'s planes")
            _check_taps(offs, (zhi - zlo + 1,) + got[0][1:], r, sub,
                        f"{label}: batch at {p0}")
    for s in range(1, S):
        _check_taps(offs, got[s], r, got[s - 1], f"{label}: sweep {s}")
    if plan.n_aux:  # the carry of sweep s, cut by r, is sweep s + 1's region
        for s in range(S - 1):
            cut = tuple(a - 2 * ri for a, ri in zip(got[s], r))
            if cut != got[s + 1]:
                raise AuditError("phi", f"{label}: aux carry {cut} of sweep "
                                 f"{s} != sweep {s + 1}'s region")
    # The protocol (temporal_body.cuh:144-225): the field windows, then
    # the sweeps' buffers by parity.
    NB = plan.stage_buffers
    blk = shadow.Block({"win": NB, "mid": 2})
    if NB == 2:
        blk.copy("win", 0, 0)
        blk.commit()
    for k in range(nf):
        more = NB == 2 and k + 1 < nf
        if NB == 1:
            blk.copy("win", 0, k)
            blk.commit()
        elif more:
            blk.copy("win", (k + 1) % 2, k + 1)
            blk.commit()
        blk.wait(1 if more else 0)
        blk.barrier()
        blk.read("win", k % NB, k, f"{label}: field {k}")
        blk.barrier()
    if S > 1:
        blk.store("mid", 0, 0)
    for s in range(1, S):
        blk.barrier()
        blk.read("mid", (s - 1) & 1, s - 1, f"{label}: sweep {s}")
        if s < S - 1:
            blk.store("mid", s & 1, s)
    pts = math.prod(tile)
    p = (np.arange(0, pts, plan.threads)[:, None]
         + np.arange(plan.threads)[None, :]).ravel()
    shadow.exactly_once(p[p < pts], pts, f"{label}: a tile's stores")
    # temporal_layout (temporal_body.cuh:52-71).
    win = NB * _r16(math.prod(window) * item)
    mid = [win, win]
    off = win
    for i in range(2):
        mid[i] = off
        if i < S - 1:
            off += _r16(nf * math.prod(regions[i]) * item)
    carry = [off, off]
    for i in range(2):
        carry[i] = off
        if plan.n_aux and i < S - 1:
            off += _r16(plan.n_aux * math.prod(regions[i + 1]) * item)
    ev = off
    if plan.strategy == "tc":
        off += 4 * math.prod(regions[0])
    else:
        off += ops.taps_per_point * _tap_bytes(item) + (ops.n_s + 1) * 4
    fields = dict(win=0, mid0=mid[0], mid1=mid[1], carry0=carry[0],
                  carry1=carry[1], eval=ev, total=off)
    return BodyRun(label, classes, off, fields)


def body_of(plan) -> str:
    """The body a plan launches (the dispatch of each ``.cu``)."""
    if plan.swc_depth1:
        return "swc_body"
    if plan.stream_depth1:
        return "stream_body"
    if plan.strategy == "swc_stream" and plan.fuse_steps == 1:
        return "stream_buffer"
    if plan.tc_depth1:
        return "tc_body"
    if plan.tc_walk:
        return "tc_walk_body"
    if plan.walk:
        return "temporal_walk_body"
    return "temporal_body"


MIRRORS = {
    "swc_body": swc_body,
    "stream_body": stream_body,
    "stream_buffer": stream_buffer,
    "tc_body": tc_body,
    "tc_walk_body": tc_walk_body,
    "temporal_walk_body": walk_body,
    "temporal_body": temporal_body,
}


def run_body(plan, ops) -> BodyRun:
    """Mirror the body ``plan`` launches (resolved at call time)."""
    return globals()[MIRRORS[body_of(plan)].__name__](plan, ops)


# ---------------------------------------------------------------------------
# B6: xcorr1d.cu
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class XcorrLaunch:
    """One B6 launch: n outputs, 2r + 1 taps (``xcorr1d.xcorr1d_cuda``)."""

    n: int
    n_taps: int
    block_size: int
    strategy: str
    unroll: int
    dtype: str
    wide: bool = True  # 16-byte staging (an aligned f; the ring only)

    @property
    def label(self) -> str:
        return (f"xcorr1d:{self.strategy}:u{self.unroll}:b{self.block_size}"
                f":k{self.n_taps}:{self.dtype}")


def xcorr1d(lc: XcorrLaunch) -> BodyRun:
    from repro_torch.kernels import xcorr1d as kx

    label = "xcorr1d"
    item = kx.ITEMSIZE[lc.dtype]
    u = kx.kernel_unroll(lc.strategy, lc.unroll)
    # The register width the kernel runs U at, in U / U_r passes.
    ur = kx.register_unroll(u)
    ring = kx.ring_route(lc.strategy, u, lc.n_taps)
    threads = kx.launch_threads(lc.block_size, lc.strategy, u, lc.n_taps)
    tiles = _cdiv(lc.n, lc.block_size)
    win = lc.block_size + lc.n_taps - 1
    numel = lc.n + lc.n_taps - 1
    classes = 0
    for tile in dict.fromkeys((0, tiles - 1)):
        base = tile * lc.block_size
        nout = min(lc.block_size, lc.n - base)
        avail = nout + lc.n_taps - 1
        shadow.check_global(np.asarray([base]), avail, numel, label)
        # Each output i < nout reads window elements i .. i + taps - 1,
        # all of them staged (< avail); elementwise's one-tile sub-blocks
        # i + e sub for i < sub.
        if lc.strategy == "elementwise" and not ring:
            sub = lc.block_size // u
            o = (np.arange(sub)[:, None] + sub * np.arange(u)[None, :])
        else:
            o = np.arange(lc.block_size)[:, None]
        o = o[o < nout]
        shadow.exactly_once(o, nout, f"{label}: tile {tile}'s stores")
        if int(o.max()) + lc.n_taps > avail:
            raise AuditError("bounds", f"{label}: an output reads past the "
                             f"{avail} staged inputs")
        if ring:
            V = 16 // item
            pad = kx.window_pad(lc.strategy, u, lc.dtype)
            units = _cdiv(win, V)
            q = np.arange(units)
            slot = q + q // pad if pad else q
            cap = kx.window_bytes(lc.n_taps, lc.block_size, lc.dtype,
                                  lc.strategy, u) // 16
            if len(set(slot.tolist())) != units or int(slot.max()) >= cap:
                raise AuditError("bounds", f"{label}: window slots reach "
                                 f"{int(slot.max())} of {cap}")
            if lc.wide and (lc.block_size * item) % 16:
                raise AuditError("bounds", f"{label}: tiles start off 16 "
                                 "bytes under wide staging")
        classes += 1
    if ring:
        stages = kx.ring_stages(lc.n_taps, lc.block_size, lc.dtype,
                                lc.strategy, u)
        shadow.prove_persistent_walk(tiles, lambda g: g, label,
                                     sample=(1, SMS, tiles))
        for mine in range(1, 5):
            blk = shadow.Block({"buf": stages})
            cur = 0
            if stages == 2:
                blk.copy("buf", 0, 0)
                blk.commit()
            for t in range(mine):
                if t + stages - 1 < mine:
                    blk.copy("buf", stages - 1 - cur, t + stages - 1)
                blk.commit()
                blk.wait(1 if stages == 2 else 0)
                blk.barrier()
                blk.read("buf", cur, t, f"{label}: tile {t}")
                cur = stages - 1 - cur
                blk.barrier()
        wbytes = kx.window_bytes(lc.n_taps, lc.block_size, lc.dtype,
                                 lc.strategy, u)
        scratch = kx.warp_scratch_bytes(lc.strategy, u, lc.dtype)
        pad = kx.window_pad(lc.strategy, u, lc.dtype)
        measured = stages * wbytes + _cdiv(threads, 32) * scratch \
            + lc.n_taps * item
    else:
        stages, wbytes, scratch, pad = 0, _r16(win * item), 0, 0
        measured = wbytes + lc.n_taps * item
    fields = dict(route=int(ring), threads=threads, pad=pad,
                  window_bytes=wbytes, scratch=scratch, stages=stages,
                  total=measured, unroll=ur, passes=u // ur)
    return BodyRun(label, classes, measured, fields)


# ---------------------------------------------------------------------------
# B7: conv1d_depthwise.cu
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Conv1dLaunch:
    """One B7 launch: x (b, s, c) with strides (sb, ss, 1), k taps, ``vec``
    channels a lane (``conv1d_depthwise.vector_width``)."""

    b: int
    s: int
    c: int
    k: int
    dtype: str
    vec: int
    sb: int = 0  # 0: contiguous (s c)
    ss: int = 0  # 0: contiguous (c)

    @property
    def label(self) -> str:
        return (f"conv1d:{self.b}x{self.s}x{self.c}:k{self.k}:v{self.vec}:"
                f"{self.dtype}")


def conv1d_depthwise(lc: Conv1dLaunch) -> BodyRun:
    from repro_torch.kernels import conv1d_depthwise as kc

    label = "conv1d_depthwise"
    sb = lc.sb or lc.s * lc.c
    ss = lc.ss or lc.c
    if lc.vec > 1 and (lc.c % lc.vec or sb % lc.vec or ss % lc.vec):
        raise AuditError("bounds", f"{label}: {lc.vec} channels a lane on "
                         f"c = {lc.c}, strides ({sb}, {ss})")
    total = kc.positions(lc.b, lc.s, lc.c, lc.vec)
    work = max(1, _cdiv(total, kc.WARPS * kc.MIN_WARP_POSITIONS))
    lanes = _cdiv(lc.c, lc.vec)
    classes = 0
    extent = (lc.b - 1) * sb + (lc.s - 1) * ss + lc.c
    for grid in dict.fromkeys((1, min(SMS, work))):
        seen = np.zeros(total, np.int64)
        for _, col, bi, t0, t1 in kc.warp_runs(lc.b, lc.s, lc.c, lc.vec,
                                               grid):
            seen[(col * lc.b + bi) * lc.s + t0:(col * lc.b + bi) * lc.s
                 + t1] += 1
            if t0 - (lc.k - 1) < -(lc.k - 1) or t1 > lc.s:
                raise AuditError("bounds", f"{label}: run [{t0}, {t1})")
        if np.any(seen != 1):
            p = int(np.argmax(seen != 1))
            raise AuditError("coverage", f"{label}: grid {grid}: position "
                             f"{p} taken {int(seen[p])} times")
        classes += 1
    # A lane runs only where its first channel is < c (:266), and then
    # its vec channels are (vec divides c): the last read is x's last.
    if (lanes - 1) * lc.vec + lc.vec > lc.c or \
            (lc.b - 1) * sb + (lc.s - 1) * ss + lc.c > extent:
        raise AuditError("bounds", f"{label}: a lane's channels pass c")
    fields = dict(threads=kc.THREADS, vec=lc.vec, positions=total,
                  work_blocks=work, total=0, taps=kc.tap_body(lc.k))
    return BodyRun(label, classes, 0, fields)
