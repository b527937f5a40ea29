"""TuningSession — model-rank → measure the top k → record (port of
``repro.tuning.session``).

The paper's Sec. 5.1 protocol, made persistent: the Hopper cost model
(``tuning.costmodel``) ranks the launches the planner accepts, the top k
are timed on the card with CUDA events (warm-up, then the median of
timed calls), and the winner is recorded in the per-device cache so
every later process — and every ``"auto"`` call site — replays it
without measuring.

Two rules of the port:

* **On a CPU tensor ``"auto"`` resolves by the model alone.** The plain
  path ignores tiles, so nothing there is worth timing: the record is
  stamped ``source="model"`` under the ``"cpu"`` backend, and a card
  never replays it (its key names the card).
* **The measured pool always holds the planner's own tile** for each
  (strategy, depth) of the key (``Candidate.default``), beside the top
  k and, in the cross-strategy search, the ``hwc`` baseline: a measured
  winner is never a tile the card times slower than today's hand-set
  choice.

A candidate whose measurement raises becomes a ``failed`` row of the
record, and later re-tunes skip it — but only a clean refusal
(:func:`discarded_launch`): a launch the card refused before it ran (an
invalid configuration or value, too many resources, out of memory), an
injected fault or a non-finite output. Anything else re-raises: a
sticky CUDA error (an illegal address, a launch failure) poisons the
context, a failed ``nvcc`` build or a Python error is a fault of the
program, and neither may hide behind the next candidate.

On the card ``hwc`` (the plain PyTorch version) is timed as the
reference's baseline but wins only where the space holds no kernel
candidate (a domain too small for any kernel); a search whose kernel
candidates all failed raises instead of recording a winner.
"""
from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any, Callable, Sequence

import torch

from repro_torch import dtype_name
from repro_torch.ft import faults as ftfaults
from repro_torch.tuning.cache import (
    TuningCache,
    TuningKey,
    TuningRecord,
    candidate_label,
    current_backend,
)
from repro_torch.tuning.costmodel import (
    Candidate1D,
    NonFiniteOutput,
    enumerate_candidates_1d,
    enumerate_candidates_nd,
    enumerate_cross_strategy_nd,
    time_candidate,
)

log = logging.getLogger("repro_torch.tuning")

# Total measurements taken by sessions in this process: a second process
# replays a persisted record with this still at zero.
MEASURE_COUNT = 0

# Global opt-in: when True, kernel call sites that pass no explicit block
# (mamba2's conv frontend) resolve as "auto". Flipped by the serve
# drivers' --auto-tune.
AUTO_ENABLED = False

# cudaError_t codes a launch returns before anything ran, leaving the
# context clean: cudaErrorInvalidValue (1), cudaErrorLaunchOutOfResources
# (7), cudaErrorInvalidConfiguration (9). Any other CUDA error may be
# sticky.
CLEAN_CUDA_ERRORS = (1, 7, 9)
_CUDA_CODE = re.compile(r"CUDA error (\d+)")


def enable_auto(on: bool = True) -> None:
    """Globally opt model call sites with no explicit block into
    ``"auto"`` resolution (the serve drivers' ``--auto-tune``)."""
    global AUTO_ENABLED
    AUTO_ENABLED = on


def discarded_launch(err: BaseException) -> bool:
    """Whether ``err`` is a clean refusal of one candidate (a ``failed``
    row) rather than a fault that must re-raise: an allocation that did
    not fit, a launch the card refused before it ran
    (:data:`CLEAN_CUDA_ERRORS`), an injected fault, or a non-finite
    output."""
    if isinstance(err, (torch.cuda.OutOfMemoryError, ftfaults.InjectedFault,
                        NonFiniteOutput)):
        return True
    code = _CUDA_CODE.search(str(err))
    return (isinstance(err, RuntimeError) and code is not None
            and int(code.group(1)) in CLEAN_CUDA_ERRORS)


@dataclasses.dataclass
class TuningSession:
    """One tuning context: a cache plus the measurement protocol knobs
    (paper: 3 timed iterations after warm-up).

    Args (dataclass fields):
        cache: the persistent per-device :class:`TuningCache`.
        top_k: how many model-ranked candidates are measured (besides
            the pinned ones: the planner's own tiles and ``hwc``).
        warmup / iters: per-candidate timing protocol.
    """

    cache: TuningCache = dataclasses.field(default_factory=TuningCache)
    top_k: int = 4
    warmup: int = 1
    iters: int = 3

    def tune(
        self,
        key: TuningKey,
        candidates: Sequence[Any] | Callable[[], Sequence[Any]],
        measure: Callable[[Any], float] | None = None,
        *,
        force: bool = False,
        pinned: Callable[[Any], bool] | None = None,
    ) -> TuningRecord:
        """Resolve ``key``: cache-hit fast path, else rank/measure/record.

        ``candidates`` are model-ranked (best first), each with a
        ``.block`` (and optionally ``.fuse_steps``, ``.stream``,
        ``.strategy``); a callable is called only on a miss (the
        enumeration is skipped on a hit). ``measure(candidate) ->
        seconds`` may raise a clean refusal (:func:`discarded_launch`)
        to discard a launch — recorded as a ``failed`` row, skipped by
        later re-tunes; any other error re-raises. ``None`` (a CPU
        tensor) takes the model's winner. ``pinned(candidate)`` marks
        the candidates measured beyond the top k. ``hwc`` is timed but
        wins only where the pool holds no kernel candidate; if kernel
        candidates were there and none measured, this raises. An
        upgradeable record (``model``/``smoke``) is re-tuned once a
        caller can measure.
        """
        if not force:
            hit = self.cache.get(key)
            if hit is not None and not (
                hit.source in ("model", "smoke") and measure is not None
            ):
                return hit
        if callable(candidates):
            candidates = candidates()
        if not candidates:
            raise ValueError(f"no tuning candidates for {key.cache_id}")

        # Known-bad candidates from a prior record's failed rows are
        # carried forward and never re-launched.
        prior = self.cache.get(key)
        known_bad = dict(prior.failed) if prior is not None else {}
        failed: dict[str, str] = {
            label: err
            for label, err in known_bad.items()
            if any(_timing_label(c) == label for c in candidates)
        }
        pool = [
            c for c in candidates if _timing_label(c) not in known_bad
        ]

        if measure is not None:
            global MEASURE_COUNT
            timings: dict[str, float] = {}
            best: tuple[float, Any] | None = None
            measured = pool[: self.top_k]
            if pinned is not None:
                measured += [
                    c for c in pool[self.top_k:] if pinned(c)
                ]
            for cand in measured:
                label = _timing_label(cand)
                try:
                    ftfaults.maybe_fail_candidate(label)
                    t = measure(cand)
                except Exception as e:
                    if not discarded_launch(e):
                        raise
                    # The paper's discarded launch, persisted so warm
                    # re-tunes skip the candidate.
                    failed[label] = f"{type(e).__name__}: {e}"
                    log.warning(
                        "tuning candidate %s failed for %s: %s",
                        label, key.cache_id, failed[label],
                    )
                    continue
                MEASURE_COUNT += 1
                timings[label] = t * 1e6
                # The plain baseline wins only a space with no kernel.
                eligible = not _is_plain(cand) or all(
                    _is_plain(c) for c in candidates)
                if eligible and (best is None or t < best[0]):
                    best = (t, cand)
            if best is None:
                raise RuntimeError(
                    f"no kernel candidate of {key.cache_id} measured; "
                    f"failed: {failed}"
                )
            record = _candidate_record(best[1], timings, "measured")
        else:
            # No measure fn (a CPU tensor): the model's winner among the
            # not-known-bad pool (source="model" keeps the record
            # upgradeable).
            record = _candidate_record(
                pool[0] if pool else candidates[0], {}, "model")
        record.failed = failed
        self.cache.put(key, record)
        return record


def _candidate_record(
    cand: Any, timings: dict[str, float], source: str
) -> TuningRecord:
    """Record for a winning candidate: the block, depth, stream flag and
    (cross-strategy searches) the resolved strategy, so a warm hit
    reproduces the whole launch decision."""
    return TuningRecord(
        block=cand.block, timings_us=timings, source=source,
        fuse_steps=getattr(cand, "fuse_steps", 1),
        stream=getattr(cand, "stream", False),
        strategy_resolved=getattr(cand, "strategy", ""),
        unroll=getattr(cand, "unroll", 1),
    )


def _is_plain(cand: Any) -> bool:
    return getattr(cand, "strategy", "") == "hwc"


def _timing_label(cand: Any) -> str:
    """Timing-table key for one candidate (``cache.candidate_label``,
    which ``TuningRecord.winner_label`` mirrors)."""
    return candidate_label(
        cand.block,
        getattr(cand, "fuse_steps", 1),
        getattr(cand, "stream", False),
        getattr(cand, "strategy", ""),
    )


# One process-wide session so all "auto" call sites share a cache view;
# rebuilt if REPRO_TORCH_TUNE_CACHE is re-pointed (tests do this).
_DEFAULT: TuningSession | None = None


def default_session() -> TuningSession:
    """The process-wide session every ``"auto"`` call site shares."""
    global _DEFAULT
    from repro_torch.tuning.cache import default_cache_dir

    if _DEFAULT is None or _DEFAULT.cache.dir != default_cache_dir():
        _DEFAULT = TuningSession()
    return _DEFAULT


# ---------------------------------------------------------------------------
# Fused stencil engine glue (block="auto", fuse_steps="auto" and
# strategy="auto" at any rank), keyed on the plan identity
# (StencilPlan.tuning_key / strategy_sid).
# ---------------------------------------------------------------------------


def fused_nd_key(
    domain: tuple[int, ...],
    radii: tuple[int, ...],
    n_f: int,
    n_out: int,
    dtype: str,
    strategy: str,
    backend: str | None = None,
    unroll: int = 1,
    fuse_steps: int | str = 1,
    batch: int = 1,
    accuracy: int = 0,
    n_aux: int = 0,
) -> TuningKey:
    """Plan-identity tuning key (mirrors ``StencilPlan.tuning_key``; the
    strategy id from the plan's ``strategy_sid``, so the two cannot
    diverge): ``:fauto`` for the joint block/depth search, ``:sauto`` for
    the cross-strategy one, ``:b{B}`` for a B-member ensemble."""
    from repro_torch.kernels.plan import strategy_sid

    rank = len(domain)
    sid = strategy_sid(
        strategy, rank, unroll, fuse_steps, batch, accuracy, n_aux
    )
    return TuningKey(
        kernel=f"fused_stencil{rank}d",
        strategy=sid,
        domain=tuple(domain),
        radii=tuple(radii),
        n_f=n_f,
        n_out=n_out,
        dtype=str(dtype),
        backend=backend if backend is not None else current_backend(),
    )


def phi_traits(phi) -> dict:
    """What the planner and the model need of φ (or the first of a
    per-step sequence): the kind's thread limit and operator slots, the
    operators it reads and its arithmetic per point."""
    from repro_torch.kernels.ops import _max_threads_of, _slots_of
    from repro_torch.kernels.phi import DevicePhi
    from repro_torch.physics.mhd import RHS_PHI_FLOPS, SUBSTEP_PHI_FLOPS

    first = phi[0] if isinstance(phi, (tuple, list)) and phi else phi
    device = isinstance(first, DevicePhi)
    flops = {"mhd_rhs": RHS_PHI_FLOPS, "mhd_substep": SUBSTEP_PHI_FLOPS}
    return dict(
        max_threads=_max_threads_of(phi),
        n_slots=_slots_of(phi),
        operators=first.operators if device else None,
        phi_flops=flops.get(first.kind, 0) if device else 0,
    )


def _is_default(cand) -> bool:
    return getattr(cand, "default", False)


def auto_block_nd(
    f_padded: torch.Tensor,
    ops,
    phi,
    n_out: int,
    *,
    aux: torch.Tensor | None = None,
    strategy: str = "swc",
    unroll: int = 1,
    fuse_steps: int = 1,
    taps=None,
) -> tuple[int, ...]:
    """Resolve ``block="auto"`` for the fused engine at any rank, the
    depth FIXED (``auto_fuse_nd`` runs the joint search). The key comes
    from a probe plan with the planner's own tile, so it names the launch
    that runs (an unroll the planner drops keys as 1; a batched operand
    as ``:b{B}``). On the card the top k, the planner's tile among them,
    are timed on ``f_padded``; on the CPU the model decides. Returns a
    rank-length block (x last)."""
    from repro_torch.kernels import ops as kops

    sess = default_session()
    traits = phi_traits(phi)
    probe = kops.plan_for_nd(
        ops, tuple(f_padded.shape), n_out,
        aux_shape=None if aux is None else tuple(aux.shape),
        strategy=strategy, dtype=dtype_name(f_padded.dtype),
        unroll=unroll, fuse_steps=fuse_steps,
        max_threads=traits["max_threads"], n_slots=traits["n_slots"],
    )
    backend = current_backend(f_padded.device)
    key = probe.tuning_key(backend)

    def candidates():
        return enumerate_candidates_nd(
            ops, probe.interior, probe.n_f, n_out, probe.dtype,
            strategies=(strategy,), fuse_steps_options=(fuse_steps,),
            unroll=probe.unroll, batch=probe.batch, n_aux=probe.n_aux,
            backend=backend, **traits,
        )

    measure = None
    if f_padded.is_cuda:

        def measure(cand):
            """Median seconds of one launch at ``cand.block``."""
            return time_candidate(
                lambda: kops.fused_stencil_nd(
                    f_padded, ops, phi, n_out, aux=aux, block=cand.block,
                    strategy=strategy, unroll=probe.unroll,
                    fuse_steps=fuse_steps, taps=taps,
                ),
                warmup=sess.warmup, iters=sess.iters,
            )

    record = sess.tune(key, candidates, measure, pinned=_is_default)
    if record.unroll != probe.unroll:
        # Candidates do not carry this search's (fixed) unroll: stamp the
        # planner's so plan_from_record round-trips :u{N}-keyed records.
        record.unroll = probe.unroll
        sess.cache.put(key, record)
    return tuple(record.block)


# The temporal depths fuse_steps="auto" sweeps (the reference's).
DEPTHS = (1, 2, 3, 4)


def _operand_dims(f_interior: torch.Tensor, ops, aux):
    """(batch, lead, domain, n_f, n_aux) of an unpadded (n_f, *spatial)
    or batched (batch, n_f, *spatial) operand."""
    batched = f_interior.ndim == ops.ndim + 2
    batch = int(f_interior.shape[0]) if batched else 1
    lead = 2 if batched else 1
    domain = tuple(int(n) for n in f_interior.shape[lead:])
    n_f = int(f_interior.shape[lead - 1])
    n_aux = int(aux.shape[lead - 1]) if aux is not None else 0
    return batch, lead, domain, n_f, n_aux


def auto_fuse_nd(
    f_interior: torch.Tensor,
    ops,
    phi,
    n_out: int,
    *,
    aux: torch.Tensor | None = None,
    strategy: str = "swc",
) -> tuple[tuple[int, ...], int]:
    """Resolve ``fuse_steps="auto"``: the JOINT (block, depth) search on
    an UNPADDED (n_f, *spatial) or batched stack, keyed ``:fauto``. On
    the card the top k (and the planner's tile at every depth) are timed
    per step over depths 1-4, the operand padded by ``radius · depth``
    (periodic) for each; on the CPU the model decides. Maps that are not
    self-maps
    (``n_out != n_f + n_aux``) and batched aux carries enumerate depth 1
    only; a φ sequence pins the depth to its length. Returns
    ``(block, fuse_steps)``."""
    sess = default_session()
    batch, _, domain, n_f, n_aux = _operand_dims(f_interior, ops, aux)
    depth_options = DEPTHS
    if isinstance(phi, (tuple, list)):
        depth_options = (len(phi),)
    if n_out != n_f + n_aux or (batch > 1 and n_aux):
        depth_options = (1,)
    backend = current_backend(f_interior.device)
    dtype = dtype_name(f_interior.dtype)
    key = fused_nd_key(
        domain, ops.radius_per_axis(), n_f, n_out, dtype, strategy,
        backend=backend, fuse_steps="auto", batch=batch,
        accuracy=ops.accuracy, n_aux=n_aux,
    )
    traits = phi_traits(phi)

    def candidates():
        return enumerate_candidates_nd(
            ops, domain, n_f, n_out, dtype, strategies=(strategy,),
            fuse_steps_options=tuple(depth_options), batch=batch,
            n_aux=n_aux, backend=backend, **traits,
        )

    measure = None
    if f_interior.is_cuda:
        measure = _interior_measure_fn(
            sess, f_interior, ops, phi, n_out, aux, strategy)
    record = sess.tune(key, candidates, measure, pinned=_is_default)
    return tuple(record.block), int(record.fuse_steps)


def _interior_measure_fn(sess, f_interior, ops, phi, n_out, aux,
                         default_strategy="swc"):
    """Measurement closure of the joint-depth and cross-strategy
    searches: median PER-STEP seconds of one candidate on the unpadded
    operand padded (periodic) by ``radius · depth`` for it (aux by
    ``radius · (depth - 1)``), so each depth times the launch it would
    run. ``hwc`` times the plain PyTorch version (the measured
    baseline); the rest their kernel at the candidate's tile and
    depth."""
    from repro_torch.core import boundary
    from repro_torch.kernels import ops as kops

    radii = ops.radius_per_axis()
    lead = f_interior.ndim - len(radii)

    def measure(cand):
        """Median per-step seconds for one candidate."""
        depth = getattr(cand, "fuse_steps", 1)
        strategy = getattr(cand, "strategy", "") or default_strategy
        fp = boundary.pad(f_interior, [r * depth for r in radii],
                          "periodic", spatial_axes=range(lead,
                                                         f_interior.ndim))
        aux_p = aux
        if aux is not None and depth > 1:
            aux_p = boundary.pad(aux, [r * (depth - 1) for r in radii],
                                 "periodic",
                                 spatial_axes=range(lead, aux.ndim))
        block = None if strategy == "hwc" else cand.block
        return time_candidate(
            lambda: kops.fused_stencil_nd(
                fp, ops, phi, n_out, aux=aux_p, block=block,
                strategy=strategy, fuse_steps=depth,
            ),
            warmup=sess.warmup, iters=sess.iters,
        ) / depth

    return measure


def auto_strategy_nd(
    f_interior: torch.Tensor,
    ops,
    phi,
    n_out: int,
    *,
    aux: torch.Tensor | None = None,
    fuse_steps: int | str = "auto",
) -> tuple[str, tuple[int, ...], int]:
    """Resolve ``strategy="auto"``: the CROSS-STRATEGY joint (strategy,
    block, depth) search on an UNPADDED operand — the paper's "no single
    caching regime wins everywhere" closed into one loop, keyed
    ``auto:sauto`` (``:fauto`` when the depth is searched too).

    The space (``costmodel.enumerate_cross_strategy_nd``): every
    ``swc``, ``swc_stream`` (rank ≥ 2, no aux) and ``tc`` (float32 or
    bfloat16) launch the planner accepts, plus the ``hwc`` baseline — a
    φ the kernels cannot run (not a ``DevicePhi``) leaves the baseline
    alone. On the card the top k, the planner's tile of every strategy
    and depth, and ``hwc`` (the plain PyTorch version) are timed; on the
    CPU the model decides. ``fuse_steps``: ``"auto"`` sweeps depths
    1-4; an int (or a φ sequence's length) pins the depth,
    and a pinned depth > 1 on a φ that is not a self-map raises, as in
    the reference. Returns ``(strategy, block, fuse_steps)``."""
    from repro_torch.kernels.phi import DevicePhi

    sess = default_session()
    batch, _, domain, n_f, n_aux = _operand_dims(f_interior, ops, aux)
    depth_options = DEPTHS
    pinned = None
    if isinstance(phi, (tuple, list)):
        pinned = len(phi)
    elif fuse_steps != "auto":
        pinned = int(fuse_steps)
    if pinned is not None:
        depth_options = (pinned,)
    if n_out != n_f + n_aux:
        if pinned is not None and pinned > 1:
            raise ValueError(
                "fuse_steps > 1 requires a self-map op with "
                f"n_out == n_f + n_aux (got n_out={n_out}, n_f={n_f}, "
                f"n_aux={n_aux}) — the cross-strategy search cannot "
                f"honor the pinned depth {pinned}"
            )
        depth_options = (1,)
    if batch > 1 and n_aux and tuple(depth_options) != (1,):
        depth_options = (1,)
    backend = current_backend(f_interior.device)
    dtype = dtype_name(f_interior.dtype)
    key = fused_nd_key(
        domain, ops.radius_per_axis(), n_f, n_out, dtype, "auto",
        backend=backend,
        fuse_steps=fuse_steps if fuse_steps == "auto" else depth_options[0],
        batch=batch, accuracy=ops.accuracy, n_aux=n_aux,
    )
    first = phi[0] if isinstance(phi, (tuple, list)) and phi else phi
    traits = phi_traits(phi)

    def candidates():
        return enumerate_cross_strategy_nd(
            ops, domain, n_f, n_out, dtype,
            fuse_steps_options=tuple(depth_options),
            kernels_ok=isinstance(first, DevicePhi), batch=batch,
            n_aux=n_aux, backend=backend, **traits,
        )

    measure = None
    if f_interior.is_cuda:
        measure = _interior_measure_fn(
            sess, f_interior, ops, phi, n_out, aux)
    record = sess.tune(
        key, candidates, measure,
        pinned=lambda c: c.strategy == "hwc" or _is_default(c),
    )
    return (
        record.resolved_strategy,
        tuple(record.block),
        int(record.fuse_steps),
    )


def lookup_fused_nd(
    f_interior: torch.Tensor,
    ops,
    n_out: int,
    strategy: str,
    fuse_steps: int | str = 1,
) -> TuningRecord | None:
    """Cached record for a fused stencil call on an UNPADDED (or
    batched) operand with no aux — the read-only mirror of the key
    derivation in ``auto_fuse_nd``/``auto_strategy_nd``
    (``fuse_steps="auto"`` for a joint record); the backend is the
    operand's device's."""
    sess = default_session()
    batched = f_interior.ndim == ops.ndim + 2
    lead = 2 if batched else 1
    key = fused_nd_key(
        tuple(int(n) for n in f_interior.shape[lead:]),
        ops.radius_per_axis(),
        int(f_interior.shape[lead - 1]),
        n_out,
        dtype_name(f_interior.dtype),
        strategy,
        backend=current_backend(f_interior.device),
        fuse_steps=fuse_steps,
        batch=int(f_interior.shape[0]) if batched else 1,
        accuracy=ops.accuracy,
    )
    return sess.cache.get(key)


# ---------------------------------------------------------------------------
# 1-D kernel glue (xcorr1d block_size="auto", conv1d block_seq="auto").
# ---------------------------------------------------------------------------

# B6's hand-set block_size (kernels.ops.xcorr1d's default), always in
# the measured pool.
XCORR_DEFAULT_BLOCK = 2048


def auto_block_xcorr1d(
    f_padded: torch.Tensor,
    g: torch.Tensor,
    *,
    strategy: str,
    unroll: int,
) -> int:
    """Resolve ``block_size="auto"`` for B6 (the 1-D cross-correlation):
    the lengths ``costmodel.enumerate_candidates_1d`` admits, the top k
    and the default 2048 timed on the card, the model's winner on the
    CPU. The key is the reference's (``xcorr1d``, ``{strategy}:u{U}``,
    n, the halo)."""
    from repro_torch.kernels import ops as kops

    sess = default_session()
    n_taps = int(g.shape[0])
    n = int(f_padded.shape[0]) - (n_taps - 1)
    backend = current_backend(f_padded.device)
    dtype = dtype_name(f_padded.dtype)
    key = TuningKey(
        kernel="xcorr1d",
        strategy=f"{strategy}:u{unroll}",
        domain=(n,),
        radii=(n_taps - 1,),
        n_f=1,
        n_out=1,
        dtype=dtype,
        backend=backend,
    )

    def candidates():
        return enumerate_candidates_1d(
            n, n_taps, strategy=strategy, unroll=unroll, dtype=dtype,
            backend=backend,
        )

    measure = None
    if f_padded.is_cuda:

        def measure(cand):
            """Median seconds of one launch at ``cand.block``."""
            return time_candidate(
                lambda: kops.xcorr1d(
                    f_padded, g, strategy=strategy,
                    block_size=int(cand.block), unroll=unroll,
                ),
                warmup=sess.warmup, iters=sess.iters,
            )

    record = sess.tune(key, candidates, measure,
                       pinned=lambda c: c.block == XCORR_DEFAULT_BLOCK)
    return int(record.block)


def auto_block_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    activation: str,
) -> int:
    """Resolve ``block_seq="auto"`` for B7 (mamba2's depthwise conv).

    Since B7's redesign ``block_seq`` no longer changes the launch: the
    kernel's persistent grid splits the sequence its own way and the
    argument is only validated (``conv1d_depthwise.check_launch``). So
    nothing is worth timing: this resolves to ``DEFAULT_BLOCK_SEQ``,
    records it under the reference's key with ``source="model"`` and
    measures nothing, on the card as on the CPU."""
    from repro_torch.kernels.conv1d_depthwise import DEFAULT_BLOCK_SEQ

    sess = default_session()
    b, s, c = (int(n) for n in x.shape)
    key = TuningKey(
        kernel="conv1d_depthwise",
        strategy=activation or "none",
        domain=(b, s, c),
        radii=(int(w.shape[0]) - 1,),
        n_f=1,
        n_out=1,
        dtype=dtype_name(x.dtype),
        backend=current_backend(x.device),
    )
    only = Candidate1D(DEFAULT_BLOCK_SEQ, smem_bytes=0, score=0.0)
    return int(sess.tune(key, [only]).block)
