"""The Hopper cost model and the measurement protocol (port of
``repro.tuning.costmodel``, re-derived for the H100).

The paper tunes thread-block shapes with a pruned search: invalid
launches discarded, a few timed iterations, the best kept. Here:

* **The static filter is the port's own planner.** A candidate is a
  (strategy, tile, depth) that :func:`~repro_torch.kernels.plan.
  plan_stencil` accepts: shared memory within ``SMEM_PER_BLOCK``, the
  thread limit, the walk's fit and column rules. Two tiles the planner
  clamps to the same launch are one candidate. The reference's
  ``VMEM_BUDGET``, 128-lane and sublane rules do not carry over.
* **The score** is modeled milliseconds per time step on the card
  (:func:`plan_score`), three terms:

  - the plan's device-memory bytes per step, halo re-fetch included
    (``core.trafficmodel``; a column walk, ``swc_stream`` and the
    depth > 1 walks, reads each column's stream extent once per
    segment), over the card's memory rate;
  - plus its FLOPs over the rate of the units that run them (the taps'
    multiply-adds and φ's arithmetic times the evaluations per
    output-step on the CUDA cores; on ``tc`` the issued MMA work,
    ``plan.tc_issued_macs``, at the tensor cores' rate);
  - both times the wave quantisation of the tiles (or columns) of a
    launch over the 132 SMs, the resident blocks of an SM sharing its
    rate.

  Two terms more, each because without it the model ranks a hand-set
  tile out of its top 4 where the card times that tile faster than
  every tile the model puts above it (``tools/tune_model_terms.py``,
  PERF.md section 6): the FLOP term is stretched by the share of an
  SM's 64 warps the resident blocks leave empty (:data:`LATENCY_WARPS`;
  512³ ``swc`` and ``tc``), and the column walks pay an exposed latency
  per barrier-separated step (:data:`STEP_SECONDS`; 8192²
  ``swc_stream``), the SM's resident blocks and the chunks in flight
  overlapping it.

  Resident blocks per SM come from shared memory (``SMEM_PER_SM``), the
  threads and the 65536 registers at the kernels' launch bounds. Scores
  within :data:`TIE` of each other are ties the model cannot resolve
  (:func:`rank`). Rates are the data sheet's (``trafficmodel.
  card_rates``, ``TC_RATES``), not measurements; a CPU run models the
  H100's.
* **Timing** (:func:`time_candidate`): warm-up calls (the first
  absorbs the kernel's ``nvcc`` build at its first use) and the median
  of ``iters`` CUDA-event intervals on the current stream, each read
  after its end event synchronizes; the first output is checked for
  NaN/inf.

The ``hwc`` baseline is the plain PyTorch version, modeled as what it
does: one pass over the field per tap, reading the shifted slice and
reading and writing the sum (:func:`hwc_candidate`). It is always in the
cross-strategy space, so that space is never empty.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import statistics
import time
from typing import Callable, Sequence

from repro_torch import ITEMSIZE
from repro_torch.core.stencil import OperatorSet
from repro_torch.core.trafficmodel import (
    TC_RATES,
    card_rates,
    stencil_batched_hbm_bytes_per_member_step,
)
from repro_torch.kernels import plan as kplan

SMS = 132  # streaming multiprocessors of an H100 SXM5
# Resident warps per SM from which the model takes the SM's arithmetic
# and shared-memory latency as hidden (Hopper's 64, the data sheet's):
# fewer stretch the compute term, as PERF.md section 5 reads for B1 and
# B3 at 16 warps per SM.
LATENCY_WARPS = 64
# Exposed time of one barrier-separated step down a column (a chunk of
# the stream, a step of planes of a walk), whose next copy the step
# waits for: a loaded device-memory round trip, about. A modeling
# constant, not a measurement (PERF.md section 6 gives the range of
# values that keeps every hand-set tile in the top 4). (The persistent
# depth-1 walks' tiles are independent, their ring's copies in flight
# across them.)
STEP_SECONDS = 2e-6
# Relative score difference below which two candidates tie: under the
# 10-15 % the card's times of one launch spread between runs (PERF.md
# section 7).
TIE = 0.05
WARP = 32
REGISTERS_PER_SM = 65536
MAX_REGISTERS = 128  # a thread's most under the kernels' launch bounds


@dataclasses.dataclass(frozen=True)
class Candidate:
    block: tuple[int, ...]  # rank-length tile, x last (the plan's)
    smem_bytes: int  # shared memory one block uses (the plan's)
    halo_overhead: float  # redundant-fetch fraction vs perfect reuse
    score: float  # modeled ms per time step (lower = better)
    fuse_steps: int = 1
    # True for swc_stream configurations (the stream axis walked).
    stream: bool = False
    # Caching regime this candidate lowers through ("hwc" | "swc" |
    # "swc_stream" | "tc").
    strategy: str = "swc"
    # Whether this is the planner's own tile for its (strategy, depth)
    # (``block=None``): the hand-set choice the measured pool keeps.
    default: bool = False


@dataclasses.dataclass(frozen=True)
class Candidate1D:
    """Block-length candidate for B6 (the 1-D cross-correlation):
    ``block`` outputs per tile."""

    block: int
    smem_bytes: int
    score: float


def halo_overhead(
    block: Sequence[int], radii: Sequence[int], fuse_steps: int = 1
) -> float:
    """Redundant-fetch fraction of one staged window vs perfect reuse
    (``Π(t + 2rS) / Π t - 1``)."""
    fetched = useful = 1
    for t, r in zip(block, radii):
        fetched *= t + 2 * r * fuse_steps
        useful *= t
    return fetched / useful - 1.0


# Per-axis tile bases on Hopper: x a multiple of an 8-wide MMA segment
# or a 32-thread warp, y a few rows to many, the slowest axis one plane
# up (on a walk, the planes of a step). Rank 1 spans the tile lengths
# the persistent kernels step through.
X_BASE_1D = (256, 512, 1024, 2048, 4096)
X_BASE = (16, 32, 64, 128, 256)
Y_BASE = (4, 8, 16, 32, 64, 128)
Z_BASE = (1, 2, 4, 8, 16)


def axis_tile_options(domain: Sequence[int]) -> tuple[tuple[int, ...], ...]:
    """Per-axis tile options for ``domain`` (x last): the Hopper bases
    capped at each extent, plus the extent itself where it is smaller
    than every base (so small domains still enumerate)."""
    bases = {1: (X_BASE_1D,), 2: (Y_BASE, X_BASE),
             3: (Z_BASE, Y_BASE, X_BASE)}[len(domain)]

    def opts(n: int, base: Sequence[int]) -> tuple[int, ...]:
        kept = [o for o in base if o <= n] or [n]
        return tuple(dict.fromkeys(kept))

    return tuple(opts(n, b) for n, b in zip(domain, bases))


def _taps(ops: OperatorSet, operators: Sequence[str] | None) -> int:
    names = ops.names if operators is None else operators
    return sum(len(ops.by_name(n).offsets) for n in names)


def resident_blocks(smem_bytes: int, threads: int) -> int:
    """Blocks an SM holds at once: what its shared memory and threads
    allow (``plan.tc_blocks_per_sm``) and its 65536 registers, each
    thread taking the most its kernel's ``__launch_bounds__`` leave it
    (128 up to 512 threads a block)."""
    regs = min(MAX_REGISTERS, REGISTERS_PER_SM // threads)
    by_regs = max(1, REGISTERS_PER_SM // (threads * regs))
    return min(kplan.tc_blocks_per_sm(smem_bytes, threads), by_regs)


def _launch_items(plan: kplan.StencilPlan) -> int:
    """Units of work the launch's blocks share out: the steps (columns)
    of a persistent walk, else one block each (the stream kernel's cross
    tiles × segments, the one-tile body's tiles), members included."""
    if plan.persistent:
        return plan.walk_items
    if plan.stream_axis is not None:
        return plan.batch * plan.segments * kplan._prod(
            n // t for n, t in zip(plan.interior[1:], plan.block[1:]))
    return plan.batch * kplan._prod(
        n // t for n, t in zip(plan.interior, plan.block[:-1] + (plan.x_step,)))


def _steps_per_sm(plan: kplan.StencilPlan, items: int, resident: int) -> float:
    """Barrier-separated steps each SM runs down its columns (0 off the
    column walks), its resident blocks and the chunks in flight
    overlapping them."""
    if not (plan.walk or plan.stream_axis is not None):
        return 0.0
    per_item = plan.interior[0] // plan.segments // plan.block[0]
    in_flight = max(1, plan.stage_buffers - 1)
    return -(-items // SMS) * per_item / (resident * in_flight)


def plan_score(
    plan: kplan.StencilPlan,
    ops: OperatorSet,
    operators: Sequence[str] | None = None,
    backend: str | None = None,
    phi_flops: int = 0,
) -> float:
    """Modeled ms per time step of ``plan`` on the card named
    ``backend`` (module docstring). ``operators`` are the ones φ reads
    (all of the set by default), ``phi_flops`` the arithmetic φ adds per
    point evaluation (``physics.mhd.RHS_PHI_FLOPS``; 0 for select)."""
    bw, f32, f64 = card_rates(backend)
    itemsize = kplan.ITEMSIZE[plan.dtype]
    depth = plan.fuse_steps
    walks = plan.walk or plan.stream_axis is not None
    block = plan.block[:-1] + (plan.x_step,)
    # Bytes of one launch: every member's fields (the streaming model on
    # a column walk, its segments re-reading their halo), aux once.
    per_step = stencil_batched_hbm_bytes_per_member_step(
        plan.interior, block, plan.radii, plan.n_f, plan.n_out, itemsize,
        batch=plan.batch, fuse_steps=depth, stream=walks,
        segments=plan.segments if walks else 1,
    )
    points = plan.batch * kplan._prod(plan.interior)
    nbytes = per_step * depth * plan.batch + plan.n_aux * points * itemsize
    evaluations = points * depth * plan.evaluations_per_output_step
    cores = f64 if plan.dtype == "float64" else f32
    flop_s = phi_flops * evaluations / cores
    if plan.strategy == "tc":
        issued, _ = kplan.tc_issued_macs(
            plan, ops, ops.names if operators is None else operators)
        flop_s += 2.0 * issued / TC_RATES[plan.dtype]
    else:
        flop_s += 2.0 * _taps(ops, operators) * plan.n_f * evaluations / cores
    resident = resident_blocks(plan.smem_bytes, plan.threads)
    warps = resident * -(-plan.threads // 32)
    hidden = min(1.0, warps / LATENCY_WARPS)
    items = _launch_items(plan)
    waves = -(-items // SMS) * SMS / items
    steps = _steps_per_sm(plan, items, resident)
    seconds = (nbytes / bw + flop_s / hidden) * waves + steps * STEP_SECONDS
    return 1e3 * seconds / depth


def hwc_score(
    domain: Sequence[int],
    n_f: int,
    n_out: int,
    itemsize: int,
    n_taps: int,
    *,
    batch: int = 1,
    backend: str | None = None,
) -> float:
    """Modeled ms per time step of the plain PyTorch version: per step
    and field, each tap reads a shifted slice and reads and writes the
    running sum (3 passes), then the outputs are written."""
    bw, _, _ = card_rates(backend)
    points = batch * math.prod(domain)
    nbytes = points * itemsize * (3 * n_taps * n_f + n_out)
    return 1e3 * nbytes / bw


def hwc_candidate(
    domain: Sequence[int],
    fuse_steps: int = 1,
    *,
    score: float = 0.0,
) -> Candidate:
    """The plain PyTorch baseline as a tuning candidate: its block is
    the per-rank default clamped to the domain (the plain path ignores
    it; the record round-trips a concrete value); ``score`` from
    :func:`hwc_score`."""
    block = tuple(
        min(t, n) for t, n in zip(kplan.DEFAULT_BLOCKS[len(domain)], domain))
    return Candidate(
        block=block, smem_bytes=0, halo_overhead=0.0, score=score,
        fuse_steps=fuse_steps, stream=False, strategy="hwc",
    )


def enumerate_candidates_nd(
    ops: OperatorSet,
    domain: Sequence[int],
    n_f: int,
    n_out: int,
    dtype: str = "float32",
    *,
    strategies: Sequence[str] = ("swc",),
    fuse_steps_options: Sequence[int] = (1,),
    unroll: int = 1,
    batch: int = 1,
    n_aux: int = 0,
    n_slots: int = 1,
    max_threads: int = kplan.MAX_THREADS,
    operators: Sequence[str] | None = None,
    backend: str | None = None,
    phi_flops: int = 0,
) -> list[Candidate]:
    """Every (strategy, tile, depth) the planner accepts for a rank-1/2/3
    ``domain`` (tiles from :func:`axis_tile_options`, plus the planner's
    own tile for each strategy and depth), deduplicated on the launch the planner makes,
    ranked by :func:`plan_score` (ties on the smaller shared memory).
    ``unroll``, ``batch``, ``n_aux``, ``n_slots`` and ``max_threads``
    are the launch's (element-wise unroll, an ensemble, aux carries, the
    φ kind); ``operators`` and ``phi_flops`` φ's (:func:`plan_score`)."""
    domain = tuple(int(n) for n in domain)
    radii = ops.radius_per_axis()
    axis_options = axis_tile_options(domain)
    lead = (batch,) if batch > 1 else ()
    found: dict[tuple, Candidate] = {}
    for strategy in strategies:
        for depth in fuse_steps_options:
            padded = lead + (n_f,) + tuple(
                n + 2 * r * depth for n, r in zip(domain, radii))
            tiles = [None] + list(itertools.product(*axis_options))
            for tile in tiles:
                try:
                    plan = kplan.plan_stencil(
                        ops, padded, n_out, strategy=strategy, block=tile,
                        dtype=dtype, n_aux=n_aux, unroll=unroll,
                        fuse_steps=depth,
                        max_threads=max_threads, n_slots=n_slots,
                    )
                except (ValueError, NotImplementedError):
                    continue  # the planner's refusal: the discarded launch
                key = (strategy, depth, plan.block)
                if key in found:
                    continue
                found[key] = Candidate(
                    block=plan.block, smem_bytes=plan.smem_bytes,
                    halo_overhead=halo_overhead(plan.block, radii, depth),
                    score=plan_score(plan, ops, operators, backend, phi_flops),
                    fuse_steps=depth, stream=strategy == "swc_stream",
                    strategy=strategy, default=tile is None,
                )
    return rank(found.values())


def rank(cands) -> list:
    """``cands`` best first: by score, scores within :data:`TIE` of the
    best of their band being ties the model cannot resolve. Ties go
    first to an x extent that is a whole number of 32-wide warp rows (a
    warp's lanes on one row), then to the smaller shared memory (the
    tile that leaves an SM room for more stages and blocks). These two
    rules keep the hand-set 8192² ``tc`` and MHD ``swc`` tiles in the
    top 4, but the card does not back them there: it times the tiles
    they lift those above at or under them (PERF.md section 6); the
    session times the top 4 and the planner's tile either way."""
    cands = list(cands)
    if not cands:
        return cands
    best = min(c.score for c in cands)

    def band(c) -> int:
        if best <= 0 or c.score <= best:
            return 0
        return int(math.log(c.score / best) / math.log1p(TIE))

    return sorted(cands, key=lambda c: (
        band(c), c.block[-1] % WARP != 0, c.smem_bytes, c.score))


def enumerate_cross_strategy_nd(
    ops: OperatorSet,
    domain: Sequence[int],
    n_f: int,
    n_out: int,
    dtype: str = "float32",
    *,
    fuse_steps_options: Sequence[int] = (1,),
    kernels_ok: bool = True,
    batch: int = 1,
    n_aux: int = 0,
    n_slots: int = 1,
    max_threads: int = kplan.MAX_THREADS,
    operators: Sequence[str] | None = None,
    backend: str | None = None,
    phi_flops: int = 0,
) -> list[Candidate]:
    """The ``strategy="auto"`` space, ranked in one list: every ``swc``,
    (rank ≥ 2, no aux) ``swc_stream`` and (float32 or bfloat16) ``tc``
    launch the planner accepts — the
    reference's rules — plus the ``hwc`` baseline at the smallest depth,
    always present. ``kernels_ok=False`` (a φ the kernels cannot run)
    leaves the baseline alone. float16 has no fused-stencil kernel yet:
    its space raises the planner's ``NotImplementedError`` (ROADMAP B9)
    rather than leave ``hwc`` alone in it."""
    if dtype == "float16" and kernels_ok:
        raise NotImplementedError(kplan.B9_NOT_PORTED)
    domain = tuple(int(n) for n in domain)
    strategies = ["swc"]
    if len(domain) >= 2 and not n_aux:
        strategies.append("swc_stream")
    if dtype in kplan.TC_DTYPES:
        strategies.append("tc")
    cands = []
    if kernels_ok:
        cands = enumerate_candidates_nd(
            ops, domain, n_f, n_out, dtype, strategies=strategies,
            fuse_steps_options=fuse_steps_options, batch=batch, n_aux=n_aux,
            n_slots=n_slots, max_threads=max_threads, operators=operators,
            backend=backend, phi_flops=phi_flops,
        )
    depth = min(fuse_steps_options)
    hwc = hwc_candidate(domain, depth, score=hwc_score(
        domain, n_f, n_out, ITEMSIZE[dtype],
        _taps(ops, operators), batch=batch, backend=backend))
    return rank([hwc] + cands)


# B6's tile lengths (outputs per tile); the reference's 1-D options.
OPTIONS_1D = (256, 512, 1024, 2048, 4096, 8192)
# bf16/f16 taps on the CUDA cores: two values an instruction (bf16x2,
# f16x2), PERF.md's rate for their bound.
BF16_PAIR = 2


def enumerate_candidates_1d(
    n: int,
    n_taps: int,
    *,
    strategy: str = "baseline",
    unroll: int = 1,
    dtype: str = "float32",
    backend: str | None = None,
) -> list[Candidate1D]:
    """B6's ``block_size`` candidates: each length the wrapper's rules
    accept (``xcorr1d.check_args``, ``check_launch``: a divisor by
    ``unroll`` on elementwise, the window and taps within a block's
    shared memory), scored like :func:`plan_score`: the tiles' windows
    (n + tiles × (taps - 1) inputs) and the outputs over the memory
    rate, plus 2 × taps FLOPs an output over the CUDA cores' rate (f32,
    f64, or bf16/f16 at ``BF16_PAIR`` times f32's) stretched by the
    resident warps, times the wave quantisation of the tiles (or the
    persistent ring's grid) over 132 SMs; values of the dtype's size."""
    from repro_torch.kernels import xcorr1d as kx

    bw, f32, f64 = card_rates(backend)
    item = kx.ITEMSIZE[dtype]
    # the taps' rate: f64 and f32 on the CUDA cores; bf16/f16 at the
    # packed pair rate (two values an instruction), as PERF.md bounds them
    rate = {8: f64, 4: f32, 2: BF16_PAIR * f32}[item]
    out = []
    for b in OPTIONS_1D:
        if b > max(n, OPTIONS_1D[0]):
            continue
        try:
            kx.check_args(strategy, b, unroll)
            kx.check_launch(n_taps, b, strategy, unroll, dtype)
        except (ValueError, NotImplementedError):
            continue
        smem = kx.smem_bytes(n_taps, b, dtype, strategy, unroll)
        threads = kx.launch_threads(b, strategy, unroll, n_taps)
        tiles = -(-n // b)
        nbytes = (n + tiles * (n_taps - 1) + n) * item
        flops = 2.0 * n_taps * n
        resident = resident_blocks(smem, threads)
        hidden = min(1.0, resident * -(-threads // 32) / LATENCY_WARPS)
        slots = SMS * resident
        waves = -(-tiles // slots) * slots / tiles
        score = 1e3 * (nbytes / bw + flops / rate / hidden) * waves
        out.append(Candidate1D(b, smem, score))
    out.sort(key=lambda c: (c.score, c.smem_bytes))
    return out


def time_candidate(
    fn: Callable[[], object],
    *,
    warmup: int = 1,
    iters: int = 3,
) -> float:
    """Median seconds of ``fn()``: ``warmup`` calls first (at least
    one; the first absorbs a kernel's build at its first use, and its
    output is checked for NaN/inf: a candidate that blows up is a
    failed row, not a winner), then ``iters`` intervals,
    each between two ``torch.cuda.Event``s recorded on the current
    stream and read once the end event has synchronized. Without a card
    (the plain path, synchronous) the host clock times each call."""
    import torch

    for i in range(max(1, warmup)):
        out = fn()
        if i == 0:
            check_finite(out)
    times = []
    cuda = torch.cuda.is_available()
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


class NonFiniteOutput(ValueError):
    """A tuning candidate's output holds NaN/inf (a ``failed`` row)."""


def check_finite(out) -> None:
    """Raise :class:`NonFiniteOutput` if a floating tensor in ``out`` (a tensor or
    a tuple/list of them) holds NaN/inf."""
    import torch

    leaves = out if isinstance(out, (tuple, list)) else (out,)
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            continue
        if not bool(torch.isfinite(leaf).all()):
            raise NonFiniteOutput(
                "candidate produced non-finite output "
                f"(shape {tuple(leaf.shape)}, dtype {leaf.dtype})"
            )
