#!/usr/bin/env python3
"""Which terms of the tuner's Hopper cost model the hand-set tiles need,
and what the card says of them.

The score (``repro_torch.tuning.costmodel.plan_score``) is bytes over
the memory rate plus FLOPs over the right rate, times the wave
quantisation, with two terms more (the latency stretch,
``LATENCY_WARPS``; the per-step latency of the column walks,
``STEP_SECONDS``) and the rank's tie rules (``TIE``: the 32-wide warp
row, then the smaller shared memory). For each tile of ``kernels/plan.py``
that was set by hand from a sweep on the card, at the shape it was swept
at, this prints its rank under the whole model and with each extra term
taken out. With ``--measure`` (needs the card) it times, with the
tuner's own protocol (CUDA events, warm-up, median), the hand-set tile
and every tile the model without a term ranks above it in its top 4: a
term is needed where the card times the hand-set tile faster than those.
Without ``--measure`` it also prints the range of ``STEP_SECONDS`` that
keeps every hand-set tile in the top 4.

    PYTHONPATH=src python3 tools/tune_model_terms.py [--measure]
"""
from __future__ import annotations

import argparse
import contextlib
import sys

import torch

from repro_torch.physics.diffusion import DiffusionProblem
from repro_torch.physics.mhd import (
    RHS_PHI_FLOPS,
    SUBSTEP_PHI_FLOPS,
    MHDSolver,
    mhd_rhs_device_phi,
    mhd_substep_device_phi,
)
from repro_torch.tuning import costmodel as cm
from repro_torch.tuning.cache import candidate_label
from repro_torch.tuning.session import (
    TuningSession,
    _interior_measure_fn,
    phi_traits,
)

# (case, strategy, depth, hand-set tile): the planner's tiles, each swept
# on the card at its shape (PERF.md section 6).
HAND_SET = [
    ("diffusion 512^3", "swc", 1, (8, 16, 32)),
    ("diffusion 512^3", "swc_stream", 1, (8, 16, 32)),
    ("diffusion 512^3", "tc", 1, (8, 8, 32)),
    ("diffusion 512^3", "swc", 2, (4, 32, 32)),
    ("diffusion 512^3", "swc", 3, (2, 32, 32)),
    ("diffusion 8192^2", "swc", 1, (64, 64)),
    ("diffusion 8192^2", "swc_stream", 1, (32, 128)),
    ("diffusion 8192^2", "tc", 1, (32, 64)),
    ("diffusion 2^26", "swc", 1, (1024,)),
    ("diffusion 2^26", "tc", 1, (512,)),
    ("MHD 256^3", "swc", 1, (2, 8, 32)),
    ("MHD 256^3", "swc_stream", 1, (1, 8, 32)),
    ("MHD 256^3", "tc", 1, (4, 8, 16)),
    ("MHD 256^3", "swc", 2, (1, 4, 16)),
    ("MHD 256^3", "tc", 2, (1, 8, 8)),
]
SHAPES = {"diffusion 512^3": (512,) * 3, "diffusion 8192^2": (8192, 8192),
          "diffusion 2^26": (1 << 26,), "MHD 256^3": (256,) * 3}
TERMS = ("latency stretch", "step latency", "tie rules")


def _score_order(cands):
    return sorted(cands, key=lambda c: (c.score, c.smem_bytes))


@contextlib.contextmanager
def without(term: str | None, step_seconds: float | None = None):
    """The model with ``term`` taken out (and ``STEP_SECONDS`` set)."""
    saved = (cm.LATENCY_WARPS, cm.STEP_SECONDS, cm.rank)
    if term == "latency stretch":
        cm.LATENCY_WARPS = 1  # every resident warp count hides it
    if term == "step latency":
        cm.STEP_SECONDS = 0.0
    if term == "tie rules":
        cm.rank = _score_order
    if step_seconds is not None:
        cm.STEP_SECONDS = step_seconds
    try:
        yield
    finally:
        cm.LATENCY_WARPS, cm.STEP_SECONDS, cm.rank = saved


def problem(case: str, depth: int, device):
    """(ops, φ, n_out, n_aux, φ's FLOPs, operand builder) of a case."""
    shape = SHAPES[case]
    if case.startswith("MHD"):
        solver = MHDSolver(shape, device=device)
        if depth == 1:
            phi, n_out, n_aux, flops = (mhd_rhs_device_phi(solver.params), 8,
                                        0, RHS_PHI_FLOPS)
        else:
            phi, n_out, n_aux, flops = (
                mhd_substep_device_phi(solver.params, 0.0, 1.0, 1e-3), 16,
                8, SUBSTEP_PHI_FLOPS)
        return solver.operator_set, phi, n_out, n_aux, flops, 8
    op = DiffusionProblem(shape, accuracy=6).step_op("swc", device=device)
    return op.ops, op.phi, 1, 0, 0, 1


def ranked(case, strategy, depth, device="cpu"):
    ops, phi, n_out, n_aux, flops, n_f = problem(case, depth, device)
    traits = phi_traits(phi)
    return cm.enumerate_candidates_nd(
        ops, SHAPES[case], n_f, n_out, strategies=(strategy,),
        fuse_steps_options=(depth,), n_aux=n_aux,
        n_slots=traits["n_slots"], max_threads=traits["max_threads"],
        operators=traits["operators"], phi_flops=flops)


def position(cands, tile) -> int | None:
    blocks = [c.block for c in cands]
    return blocks.index(tile) + 1 if tile in blocks else None


def label(c) -> str:
    return candidate_label(c.block, c.fuse_steps, c.stream, c.strategy)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--measure", action="store_true",
                    help="time the displaced tiles on the card")
    args = ap.parse_args(argv)
    if args.measure and not torch.cuda.is_available():
        print("--measure needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda" if args.measure else "cpu")
    needed = {t: [] for t in TERMS}
    print("rank of each hand-set tile: whole model, then without each term")
    for case, strategy, depth, tile in HAND_SET:
        whole = ranked(case, strategy, depth)
        row = [position(whole, tile)]
        displaced = {}
        for term in TERMS:
            with without(term):
                cands = ranked(case, strategy, depth)
            row.append(position(cands, tile))
            if row[-1] is None or row[-1] > 4:
                displaced[term] = [c for c in cands[:4]]
                needed[term].append((case, strategy, depth, tile, cands[:4]))
        print(f"  {case:17s} {strategy:10s} S={depth} {tile!s:14s} "
              + "  ".join(f"{t}: {r}" for t, r in zip(("whole",) + TERMS,
                                                       row)))
    if not args.measure:
        print("STEP_SECONDS values and the hand-set tiles out of the top 4:")
        for value in (0.0, 0.25e-6, 0.5e-6, 1e-6, 2e-6, 4e-6, 8e-6, 16e-6):
            with without(None, step_seconds=value):
                misses = [(c, s, d) for c, s, d, t in HAND_SET
                          if (position(ranked(c, s, d), t) or 99) > 4]
            print(f"  {value:.2e} s: {len(misses)} {misses}")
        return 0
    print("the card (CUDA events, median of 5 after a warm-up), "
          f"{torch.cuda.get_device_name(0)}: per-step ms of the hand-set "
          "tile and of the tiles the model without a term ranks above it")
    sess = TuningSession(warmup=1, iters=5)
    gen = torch.Generator(device=dev).manual_seed(0)
    for term in TERMS:
        for case, strategy, depth, tile, top in needed[term]:
            ops, phi, n_out, n_aux, _, n_f = problem(case, depth, dev)
            shape = SHAPES[case]
            f = torch.randn((n_f,) + shape, generator=gen, device=dev)
            aux = (torch.randn((n_aux,) + shape, generator=gen, device=dev)
                   if n_aux else None)
            measure = _interior_measure_fn(sess, f, ops, phi, n_out, aux,
                                           strategy)
            hand = next(c for c in ranked(case, strategy, depth)
                        if c.block == tile)
            hand_ms = measure(hand) * 1e3
            others = [(label(c), measure(c) * 1e3) for c in top]
            verdict = ("needed" if all(hand_ms < ms for _, ms in others)
                       else "not shown")
            print(f"  [{term}] {case} {strategy} S={depth}: hand-set "
                  f"{label(hand)} {hand_ms:.4f} ms vs "
                  + ", ".join(f"{lb} {ms:.4f} ms" for lb, ms in others)
                  + f" -> {verdict}")
            del f, aux
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
