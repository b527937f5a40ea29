"""Modeled device-memory traffic and redundant work of temporal fusion
and of slowest-axis streaming (the port's own copy of the stencil half
of ``repro.core.trafficmodel``; numpy-free, no JAX).

A ``fuse_steps``-deep launch stages each tile with a ``radii *
fuse_steps`` halo, writes the interior once and advances that many time
steps; its intermediate sweeps recompute the halo shells the unfused
schedule would have read back. A streaming launch reads each column's
stream extent once, carrying the stream-axis halo on chip.
``chip_smoke.py`` prints these figures beside the temporal and stream
kernel rows.
"""
from __future__ import annotations

from typing import Sequence


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def stencil_hbm_bytes_per_step(
    domain: Sequence[int],
    block: Sequence[int],
    radii: Sequence[int],
    n_f: int,
    n_out: int,
    itemsize: int,
    fuse_steps: int = 1,
) -> float:
    """Modeled device-memory bytes moved per simulated TIME step.

    One kernel launch stages, per block, the tile plus a halo widened to
    ``radii * fuse_steps`` (reads), writes the interior tile once, and
    advances ``fuse_steps`` steps — so the per-step traffic is the whole
    launch divided by the depth. Depth 1 reduces to the classic
    read-tile-plus-halo / write-tile model.
    """
    if fuse_steps < 1:
        raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
    n_blocks, read_per_block, points = 1, n_f, 1
    for n, t, r in zip(domain, block, radii):
        n_blocks *= _ceil_div(n, t)
        read_per_block *= t + 2 * r * fuse_steps
        points *= n
    read = n_blocks * read_per_block
    write = n_out * points
    return (read + write) * itemsize / fuse_steps


def stencil_stream_hbm_bytes_per_step(
    domain: Sequence[int],
    block: Sequence[int],
    radii: Sequence[int],
    n_f: int,
    n_out: int,
    itemsize: int,
    fuse_steps: int = 1,
    *,
    segments: int = 1,
) -> float:
    """Modeled device-memory bytes per simulated TIME step of the
    explicit-streaming kernel (``swc_stream``, paper Fig. 5b), any depth.

    The stream walks axis 0 (z at rank 3, y at rank 2) carrying
    ``2·r₀·fuse_steps`` halo planes on chip between chunks, so each
    cross-stream tile column reads the stream extent plus ONE
    leading/trailing halo: ``N₀ + 2·r₀·S`` planes of the
    ``Π(τ_a + 2·r_a·S)`` cross window; cross-axis halos are still read
    again per column. The interior is written once; a launch advances
    ``fuse_steps`` steps, so the total is divided by the depth.
    ``segments`` > 1 (the port cuts the stream axis into pieces walked
    by separate blocks) reads the halo once per piece:
    ``N₀ + 2·r₀·S·segments`` planes; 1 is the reference's model.
    """
    if fuse_steps < 1:
        raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
    n_cols, read_per_col, points = 1, n_f, 1
    for a, (n, t, r) in enumerate(zip(domain, block, radii)):
        points *= n
        if a == 0:
            read_per_col *= n + 2 * r * fuse_steps * segments
        else:
            n_cols *= _ceil_div(n, t)
            read_per_col *= t + 2 * r * fuse_steps
    read = n_cols * read_per_col
    write = n_out * points
    return (read + write) * itemsize / fuse_steps


def stencil_redundant_compute_fraction(
    block: Sequence[int],
    radii: Sequence[int],
    fuse_steps: int = 1,
) -> float:
    """Extra stencil evaluations per useful output point under temporal
    fusion: sweep ``s`` of ``S`` covers the tile plus a
    ``radii * (S - 1 - s)`` margin (the valid region shrinks one radius
    per sweep), so fused blocks recompute halo points the unfused
    schedule would have read from device memory. Returns 0.0 at depth 1.
    """
    tile = 1
    for t in block:
        tile *= t
    total = 0
    for s in range(fuse_steps):
        vol = 1
        for t, r in zip(block, radii):
            vol *= t + 2 * r * (fuse_steps - 1 - s)
        total += vol
    return total / (fuse_steps * tile) - 1.0
