"""The auditor's abstract domain (the port's counterpart of
``repro.analysis.shadow``).

The reference shadow-runs its Pallas bodies on interval refs. The port's
bodies are CUDA, so :mod:`repro_torch.analysis.bodies` mirrors each one's
geometry in Python and drives the three parts here:

* **The strict half-open box algebra.** Nothing clamps: an empty box, or
  one that leaves the extents it indexes, raises :class:`AuditError`
  (class ``bounds``) where numpy would silently cut the slice.
* **The slot-provenance tracker** (:class:`Block`). Each ring slot or
  buffer of one block records the label of what it holds (a global plane,
  a window, a sweep's plane), the cp.async group that copies it and
  whether the copy has landed. Copies land when a wait leaves their group
  out of the newest ones in flight; what landed, and what threads stored,
  is visible after the next barrier. A read of a slot that is not visible
  is ``uninit``, of one holding another label ``bounds``; a copy or store
  into a slot read since the last barrier is ``uninit`` (the read may
  still be in progress).
* **The granule rule for 16-byte copies** (:func:`congruent_rows`,
  :func:`shifted_rows`). Every ``cp_async16`` source is one aligned
  16-byte granule of the input that holds at least one element of its
  window row. The bytes it brings from outside the row lie in the granule
  of the row's first or last element, so they are inside the allocation
  whatever the tensor's offset, and no tap reads them: the tap proofs hold
  every read inside the window box.

Persistent walks (``csrc/persistent.cuh``) are proved by
:func:`prove_persistent_walk` for every grid from 1 to the launch's items.
"""
from __future__ import annotations

from typing import Any, Hashable, Sequence

import numpy as np

from repro_torch.analysis.findings import AuditError

Box = tuple[tuple[int, int], ...]  # per-axis (lo, hi), half-open


# ---------------------------------------------------------------------------
# Box algebra
# ---------------------------------------------------------------------------


def check_box(box: Box, extents: Sequence[int], label: str) -> Box:
    """``box`` if it is non-empty and inside ``[0, extents)`` on every
    axis; else :class:`AuditError` (``bounds``)."""
    if len(box) != len(extents):
        raise AuditError("bounds", f"{label}: box {box} of rank "
                         f"{len(box)} on extents {tuple(extents)}")
    for a, ((lo, hi), n) in enumerate(zip(box, extents)):
        if lo < 0 or hi > n or lo >= hi:
            raise AuditError(
                "bounds", f"{label}: axis {a} [{lo}, {hi}) outside [0, {n}) "
                "or empty")
    return tuple((int(lo), int(hi)) for lo, hi in box)


def exactly_once(points: np.ndarray, n: int, label: str) -> None:
    """The integer ``points`` are ``0 .. n-1``, each once: else
    ``coverage`` (a point stored twice or never) or ``bounds`` (a point
    past the tile)."""
    points = np.asarray(points, dtype=np.int64).ravel()
    if points.size and (points.min() < 0 or points.max() >= n):
        bad = points[(points < 0) | (points >= n)][0]
        raise AuditError("bounds", f"{label}: store {int(bad)} outside "
                         f"[0, {n})")
    counts = np.bincount(points, minlength=n)
    if np.any(counts != 1):
        p = int(np.argmax(counts != 1))
        raise AuditError("coverage", f"{label}: point {p} of {n} stored "
                         f"{int(counts[p])} times")


# ---------------------------------------------------------------------------
# The slot-provenance tracker
# ---------------------------------------------------------------------------


class Block:
    """The shared memory of one block as its rings of slots (a slot: a
    window buffer, a plane of a ring, a whole buffer) and the cp.async
    groups in flight. Labels are any hashable value the mirror chooses
    (the global plane a slot holds, a unit's (step, field))."""

    def __init__(self, rings: dict[str, int]):
        self.n = dict(rings)
        self.label = {r: [None] * n for r, n in rings.items()}
        self.group = {r: [-1] * n for r, n in rings.items()}
        self.landed = {r: [False] * n for r, n in rings.items()}
        self.ready = {r: [False] * n for r, n in rings.items()}
        self.read_since = {r: [False] * n for r, n in rings.items()}
        self.open = 0  # the group that copies issued now join

    def _slot(self, ring: str, slot: int, what: str) -> int:
        if not 0 <= slot < self.n[ring]:
            raise AuditError("bounds", f"{what} {ring} slot {slot} outside "
                             f"[0, {self.n[ring]})")
        return slot

    def _write(self, ring, slot, label, landed, what) -> None:
        slot = self._slot(ring, slot, what)
        if self.read_since[ring][slot]:
            raise AuditError(
                "uninit", f"{what} into {ring} slot {slot} ({label!r}) issued "
                f"before the barrier that follows its read of "
                f"{self.label[ring][slot]!r}")
        self.label[ring][slot] = label
        self.group[ring][slot] = -1 if landed else self.open
        self.landed[ring][slot] = landed
        self.ready[ring][slot] = False

    def copy(self, ring: str, slot: int, label: Hashable) -> None:
        """Issue a cp.async of ``label`` into ``ring[slot]`` (the open
        group)."""
        self._write(ring, slot, label, False, "copy")

    def store(self, ring: str, slot: int, label: Hashable) -> None:
        """Threads write ``label`` into ``ring[slot]`` (visible after the
        next barrier)."""
        self._write(ring, slot, label, True, "store")

    def commit(self) -> None:
        self.open += 1

    def wait(self, newest_in_flight: int) -> None:
        """``cp.async.wait_group n``: every committed group but the newest
        ``n`` has landed."""
        done = self.open - newest_in_flight
        for r in self.n:
            for s in range(self.n[r]):
                g = self.group[r][s]
                if 0 <= g < done:
                    self.landed[r][s] = True

    def barrier(self) -> None:
        for r in self.n:
            for s in range(self.n[r]):
                self.ready[r][s] = self.landed[r][s]
                self.read_since[r][s] = False

    def read(self, ring: str, slot: int, label: Hashable, what: str) -> None:
        """A read of ``ring[slot]`` that needs it to hold ``label``."""
        slot = self._slot(ring, slot, what)
        held = self.label[ring][slot]
        if held is None or not self.ready[ring][slot]:
            raise AuditError(
                "uninit", f"{what}: {ring} slot {slot} read for {label!r} "
                + ("never written" if held is None else
                   f"before its copy of {held!r} landed"))
        if held != label:
            raise AuditError(
                "bounds", f"{what}: {ring} slot {slot} holds {held!r}, the "
                f"tap needs {label!r}")
        self.read_since[ring][slot] = True


# ---------------------------------------------------------------------------
# Staging proofs (element rows; numpy over the rows of one fetch)
# ---------------------------------------------------------------------------


def _disjoint(lo: np.ndarray, hi: np.ndarray, label: str) -> None:
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    if lo.size > 1 and np.any(lo[1:] < hi[:-1]):
        i = int(np.argmax(lo[1:] < hi[:-1]))
        raise AuditError("bounds", f"{label}: the copies of two rows meet "
                         f"at shared elements [{int(lo[i + 1])}, "
                         f"{int(hi[i])})")


def check_global(G: np.ndarray, wx: int, numel: int, label: str) -> None:
    """Every window row [G, G + wx) lies in the input's ``numel``
    elements."""
    if G.size and (G.min() < 0 or G.max() + wx > numel):
        raise AuditError("bounds", f"{label}: a window row reaches "
                         f"[{int(G.min())}, {int(G.max()) + wx}) of an input "
                         f"of {numel} elements")


def congruent_rows(G: np.ndarray, B: np.ndarray, wx: int, V: int, base: int,
                   limit: int, label: str) -> None:
    """The 16-byte staging into buffers congruent to the input modulo 16
    bytes (``swc_body.cuh``, ``stream_body.cuh``,
    ``temporal_walk_body.cuh``): window row r, global elements [G_r, G_r +
    wx), lands at shared elements B_r ..; its chunk q is the granule at G_r
    − a_r + qV (a_r = (base + G_r) mod V) copied to B_r − a_r + qV, for the
    q with qV < a_r + wx, at most ``cdiv(wx + V − 1, V)`` of them. Proves:
    each destination is 16-byte aligned (B_r ≡ a_r mod V: the congruence),
    each granule holds an element of its row (the granule rule), the
    chunks cover the row, stay inside ``[0, limit)`` shared elements, and
    no two rows' chunks meet."""
    G = np.asarray(G, np.int64)
    B = np.asarray(B, np.int64)
    a = (base + G) % V
    off = (B - a) % V
    if np.any(off):
        i = int(np.argmax(off != 0))
        raise AuditError(
            "bounds", f"{label}: row {i} (shared element {int(B[i])}, input "
            f"{int(a[i])} elements into its granule) lands {int(off[i])} "
            "elements off a 16-byte boundary: the buffer's pitch is not "
            "congruent to the input's modulo 16 bytes")
    chunks = (a + wx + V - 1) // V  # qV < a + wx
    cq = -(-(wx + V - 1) // V)
    if np.any(chunks > cq):
        raise AuditError("uninit", f"{label}: a row needs {int(chunks.max())}"
                         f" chunks, the staging issues {cq}")
    lo = B - a
    hi = lo + chunks * V
    if lo.min() < 0 or hi.max() > limit:
        raise AuditError("bounds", f"{label}: copies reach shared elements "
                         f"[{int(lo.min())}, {int(hi.max())}) of {limit}")
    _disjoint(lo, hi, label)


def shifted_rows(G: np.ndarray, R: np.ndarray, wx: int, V: int, base: int,
                 pitch: int, limit: int, label: str) -> np.ndarray:
    """The 16-byte staging of ``tc_body.cuh``: buffer row r starts at the
    16-byte aligned shared element R_r and holds the granules from G_r −
    s_r on (s_r = (base + G_r) mod V), chunk q the granule at G_r − s_r +
    qV with its first min(V, wx − qV + s_r) elements read and the rest
    zero-filled, for q < cdiv(wx + V − 1, V). Proves the destinations
    aligned, the chunks inside the row's pitch and the buffer, the row
    covered, and the rows apart. Returns the shifts s_r."""
    G = np.asarray(G, np.int64)
    R = np.asarray(R, np.int64)
    if pitch % V or np.any(R % V):
        raise AuditError("bounds", f"{label}: a buffer row starts off 16 "
                         f"bytes (pitch {pitch}, V {V})")
    s = (base + G) % V
    cq = -(-(wx + V - 1) // V)
    if np.any(s + wx > cq * V):
        raise AuditError("uninit", f"{label}: a row's {wx} elements from "
                         f"shift {int(s.max())} pass its {cq} chunks")
    if cq * V > pitch:
        raise AuditError("bounds", f"{label}: {cq} chunks of a row pass its "
                         f"pitch of {pitch} elements")
    if R.min() < 0 or R.max() + pitch > limit:
        raise AuditError("bounds", f"{label}: rows reach shared elements "
                         f"[{int(R.min())}, {int(R.max()) + pitch}) of "
                         f"{limit}")
    _disjoint(R, R + pitch, label)
    return s


def element_rows(B: np.ndarray, wx: int, limit: int, label: str) -> None:
    """Element copies (``stage_window`` of ``stencil_sweep.cuh``, B6's
    element staging): row r's wx elements land at B_r .. inside ``[0,
    limit)`` and apart."""
    B = np.asarray(B, np.int64)
    if B.min() < 0 or B.max() + wx > limit:
        raise AuditError("bounds", f"{label}: rows reach shared elements "
                         f"[{int(B.min())}, {int(B.max()) + wx}) of {limit}")
    _disjoint(B, B + wx, label)


# ---------------------------------------------------------------------------
# Persistent walks
# ---------------------------------------------------------------------------


def prove_persistent_walk(items: int, stride_of: Any, label: str,
                          sample: Sequence[int] = ()) -> None:
    """The persistent walk of ``persistent.cuh``: block b of ``grid``
    takes items b, b + stride, ... with stride ``stride_of(grid)`` (the
    Walker's advance). Proved for every grid from 1 to ``items``: the
    stride must be the grid, since block b < grid starts at item b and the
    residues b mod grid then partition [0, items) exactly once. The grids
    of ``sample`` are also enumerated item by item."""
    grids = np.arange(1, items + 1, dtype=np.int64)
    strides = np.asarray([stride_of(int(g)) for g in grids], np.int64) \
        if items <= 4096 else None
    if strides is None:
        # Past 4096 grids, the advance is checked on every grid in steps
        # and at both ends, and enumerated on ``sample``.
        pick = np.unique(np.concatenate([
            np.arange(1, min(items, 64) + 1),
            np.linspace(1, items, 257).astype(np.int64),
            np.arange(max(1, items - 63), items + 1)]))
        grids = pick
        strides = np.asarray([stride_of(int(g)) for g in grids], np.int64)
    bad = strides != grids
    if np.any(bad):
        g = int(grids[np.argmax(bad)])
        raise AuditError("coverage", f"{label}: a grid of {g} blocks "
                         f"advances by {stride_of(g)} items, not {g}: items "
                         "are taken twice or never")
    i = np.arange(items, dtype=np.int64)
    for g in sample:
        g = max(1, min(int(g), items))
        st = max(int(stride_of(g)), 1)
        # Blocks taking item i: b ≡ i (mod st), b <= i, b < g.
        top = np.minimum(i, g - 1)
        res = i % st
        counts = np.where(res <= top, (top - res) // st + 1, 0)
        if np.any(counts != 1):
            k = int(np.argmax(counts != 1))
            raise AuditError("coverage", f"{label}: grid {g}: item {k} of "
                             f"{items} taken {int(counts[k])} times")
