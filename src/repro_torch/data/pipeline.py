"""Deterministic, host-sharded data pipeline (port of
``repro.data.pipeline``, a copy: the port imports nothing of ``repro``,
not even this numpy-only module).

The *global* batch for step ``s`` is a pure function of ``(seed, s)``:
any host materializes exactly its slice (``host_index / host_count``),
so a restart resumes bit-identically mid-stream with no data state in
the checkpoint: the data cursor is the step counter. The batches are
the reference's, bit for bit (the same numpy draws).

Two LM datasets:
* ``SyntheticLMDataset`` — uniform tokens (throughput benchmarking).
* ``MarkovLMDataset``    — order-1 Markov chain with a sparse transition
  structure; a model CAN learn it, so a training shows a real,
  reproducible loss drop toward the chain's entropy rate.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int, start: int, count: int) -> dict[str, np.ndarray]:
        """Rows [start, start+count) of step ``step``'s global batch.

        Seeded PER ROW, so any host slicing of the global batch yields
        identical rows (the elastic-resharding invariant)."""
        tok = np.stack([
            np.random.default_rng(
                np.random.SeedSequence([self.seed, step, start + i])
            ).integers(0, self.vocab, size=self.seq_len + 1, dtype=np.int32)
            for i in range(count)
        ])
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@dataclasses.dataclass(frozen=True)
class MarkovLMDataset:
    """Order-1 Markov chain over the vocab: each state transitions to one
    of ``branching`` successors (structure drawn once from ``seed``)."""

    vocab: int
    seq_len: int
    branching: int = 4
    seed: int = 0

    def _table(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.integers(
            0, self.vocab, size=(self.vocab, self.branching), dtype=np.int32
        )

    @property
    def entropy_rate(self) -> float:
        return float(np.log(self.branching))

    def batch(self, step: int, start: int, count: int) -> dict[str, np.ndarray]:
        table = self._table()
        tok = np.empty((count, self.seq_len + 1), dtype=np.int32)
        choices = np.empty((count, self.seq_len), dtype=np.int64)
        for i in range(count):  # per-row seeding: host-slicing invariant
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed + 1, step, start + i])
            )
            tok[i, 0] = rng.integers(0, self.vocab)
            choices[i] = rng.integers(0, self.branching, size=self.seq_len)
        for t in range(self.seq_len):
            tok[:, t + 1] = table[tok[:, t], choices[:, t]]
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _process_rank_and_count() -> tuple[int, int]:
    """(rank, world size) of ``torch.distributed`` when it is
    initialised, else (0, 1): the reference's ``jax.process_index`` and
    ``process_count``."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class BatchIterator:
    """Host-sharded iterator over global batches.

    ``global_batch`` rows per step; this host materializes rows
    ``[host_index·per_host, (host_index+1)·per_host)`` and (optionally)
    moves them to its device.
    """

    def __init__(
        self,
        dataset,
        global_batch: int,
        *,
        host_index: int | None = None,
        host_count: int | None = None,
        start_step: int = 0,
    ):
        self.dataset = dataset
        self.global_batch = global_batch
        rank, world = _process_rank_and_count()
        self.host_index = rank if host_index is None else host_index
        self.host_count = world if host_count is None else host_count
        if global_batch % self.host_count:
            raise ValueError("global_batch must divide by host count")
        self.per_host = global_batch // self.host_count
        self.step = start_step

    def next_local(self) -> dict[str, np.ndarray]:
        b = self.dataset.batch(
            self.step, self.host_index * self.per_host, self.per_host
        )
        self.step += 1
        return b

    def next_global(self, device: str | torch.device | None = None
                    ) -> dict[str, torch.Tensor]:
        """This host's slice as tensors on ``device`` (the card by
        default). The reference assembles a globally sharded
        ``jax.Array`` here; on one card (and, with the data-parallel
        slice, on each rank's card) the local rows are the batch."""
        dev = resolve_device(device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in self.next_local().items()}


def make_physics_init(shape, n_fields: int, amplitude: float, seed: int = 0):
    """Paper Table B2 benchmark initialization for physics domains."""
    rng = np.random.default_rng(seed)
    return rng.uniform(
        -amplitude, amplitude, size=(n_fields,) + tuple(shape)
    ).astype(np.float32)
