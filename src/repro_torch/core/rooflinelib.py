"""Roofline terms for the port (the counterpart of
``repro.core.rooflinelib``), with the card's rates in place of the TPU
v5e's:

  compute term    = FLOPs        / peak FLOP/s of the step's dtype
  memory term     = bytes        / device-memory rate
  collective term = wire bytes   / NVLink rate (one direction)

per rank. The reference reads FLOPs and bytes from XLA's
``cost_analysis()`` and parses its collectives out of the compiled HLO
text; eager PyTorch has neither. The port's dry run (``launch.dryrun``)
counts FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` and the
collectives from ``distrib.comm.counts`` (:func:`collective_stats`),
which already count each call's bytes by the ring model the
reference's ``parse_collectives`` uses; the memory term is the traffic
model's (``core.trafficmodel.modeled_hbm_bytes``), as the reference's
roofline table takes it.

:data:`H100_SXM5`'s rates are the card's data-sheet figures (NVIDIA
H100 SXM5), not measurements: the memory rate and the f32 rate come
from ``trafficmodel.CARD_RATES``, the bf16 tensor-core rate from
``trafficmodel.TC_RATES``, so the tuner, the kernel bounds and this
module read one copy of each.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core import trafficmodel as tm


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float  # FLOP/s per card
    peak_flops_f32: float
    hbm_bw: float  # bytes/s per card
    link_bw: float  # bytes/s per card, one direction (NVLink)
    smem_bytes: int  # shared memory a block may hold (VMEM's place)
    hbm_bytes: int
    tdp_watts: float

    def machine_balance(self, dtype_bytes: int = 2) -> float:
        peak = self.peak_flops_bf16 if dtype_bytes == 2 else self.peak_flops_f32
        return peak / self.hbm_bw


_HBM_RATE, _F32_RATE, _ = tm.CARD_RATES["H100"]

# NVIDIA H100 SXM5, data sheet: 3.35 TB/s HBM3, 989 TFLOP/s dense bf16
# (tensor cores), 67 TFLOP/s f32 (no tensor cores), NVLink 900 GB/s
# both directions (450 GB/s each way), 80 GB, 227 KB of shared memory a
# block, 700 W.
H100_SXM5 = HardwareSpec(
    name="NVIDIA H100 SXM5 (data sheet)",
    peak_flops_bf16=tm.TC_RATES["bfloat16"],
    peak_flops_f32=_F32_RATE,
    hbm_bw=_HBM_RATE,
    link_bw=450e9,
    smem_bytes=227 * 1024,
    hbm_bytes=80 * 10**9,
    tdp_watts=700.0,
)

# The collectives ``distrib.comm`` counts, by the reference's HLO names.
_COLLECTIVES = {
    "all_gather": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter": "reduce-scatter",
}


@dataclasses.dataclass
class CollectiveStats:
    """Per-rank collective calls and wire bytes (the ring model: an
    all-reduce of B bytes over n ranks sends 2(n−1)/n·B, a
    reduce-scatter of B input bytes and an all-gather of B output bytes
    (n−1)/n·B)."""

    counts: dict[str, int]
    wire_bytes: int

    @property
    def total_wire_bytes(self) -> int:
        return self.wire_bytes


def collective_stats(counts: Mapping[str, int]) -> CollectiveStats:
    """:class:`CollectiveStats` from ``distrib.comm.counts`` (or a copy
    of it): the calls by collective and the bytes this rank sent."""
    return CollectiveStats(
        {name: int(counts.get(key, 0)) for key, name in _COLLECTIVES.items()
         if counts.get(key, 0)},
        int(counts.get("bytes", 0)))


@dataclasses.dataclass
class Roofline:
    flops: float  # per rank
    hbm_bytes: float  # per rank
    collective_wire_bytes: float  # per rank
    chips: int
    hw: HardwareSpec = H100_SXM5
    dtype_bytes: int = 2

    @property
    def peak_flops(self) -> float:
        return (self.hw.peak_flops_bf16 if self.dtype_bytes == 2
                else self.hw.peak_flops_f32)

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        # each rank drives its own links: its wire bytes over one link
        return self.collective_wire_bytes / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def useful_flops_fraction(self, model_flops_per_chip: float) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundancy waste."""
        return model_flops_per_chip / max(self.flops, 1.0)

    def roofline_fraction(self, model_flops_per_chip: float) -> float:
        """Useful-FLOP throughput vs peak if the step ran at its bound:
        (model FLOPs / bound-time) / peak — the MFU-style score."""
        return model_flops_per_chip / (self.bound_s * self.peak_flops)

    def summary(self) -> dict[str, Any]:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_wire_bytes": self.collective_wire_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops_train(n_params: float, n_tokens: float) -> float:
    """6·N·D (fwd 2ND + bwd 4ND) — dense; pass active params for MoE."""
    return 6.0 * n_params * n_tokens


def model_flops_decode(n_params: float, n_tokens: float) -> float:
    """2·N per generated token (fwd only)."""
    return 2.0 * n_params * n_tokens


def stencil_ideal_bytes(
    n_points: float, n_f: int, n_out: int, dtype_bytes: int
) -> float:
    """The paper's 'ideal performance' bound (Sec. 5.4): the domain is
    read and written exactly once at peak bandwidth."""
    return n_points * (n_f + n_out) * dtype_bytes


def stencil_mxu_roof_s(
    flops: float, dtype_bytes: int = 4, hw: HardwareSpec = H100_SXM5
) -> float:
    """Compute roof next to the bandwidth roof: seconds the strategy
    ``"tc"`` needs at the card's peak rate for ``flops`` contraction
    FLOPs: bf16 on the tensor cores, f32 at the f32 rate (the f32 ``tc``
    route contracts on the f64 MMA, whose data-sheet rate is the same
    67 TFLOP/s)."""
    peak = hw.peak_flops_bf16 if dtype_bytes == 2 else hw.peak_flops_f32
    return flops / peak
