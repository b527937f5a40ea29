"""Persistent on-disk tuning cache (port of ``repro.tuning.cache``, a
copy: the port imports nothing of ``repro``).

The paper's central tuning result (Sec. 5.1, Fig. 14) is that block
shapes must be re-tuned per platform — so winners are cached *per device
kind* (``torch.cuda.get_device_name()`` on the card, ``"cpu"`` for a
CPU tensor) and reused across processes: tune once, run tuned forever
after. A record taken on one backend never replays on another.

Layout: one JSON file (``cache.json``) under ``$REPRO_TORCH_TUNE_CACHE``
or ``~/.cache/repro-torch-tune/`` — never the JAX package's
``repro-tune`` file — mapping a stable key string → record. Records
carry a schema version; bumping ``SCHEMA_VERSION`` invalidates every old
record (they are dropped at load). Writes are atomic (tmp + rename) and
hold an advisory file lock around the read-merge-write, so concurrent
processes on the same host compose instead of clobbering each other
(on platforms without ``fcntl`` the merge still bounds the race: a lost
record is simply re-measured later). A corrupt ``cache.json``
(truncated or garbled by a crashed writer) is quarantined — renamed
aside to ``cache.json.corrupt*`` with a warning — so the bad bytes
stay inspectable while every record re-tunes from a clean file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Iterator, Union

log = logging.getLogger("repro_torch.tuning")

try:
    import fcntl
except ImportError:  # non-posix: fall back to lock-free merge
    fcntl = None  # type: ignore[assignment]

# v2: records gained ``stream`` + ``strategy_resolved`` (the explicit-
# streaming flag and the strategy a cross-strategy "auto" search picked
# were previously dropped on the warm-cache path). Migration is by
# invalidation: v1 records are dropped at load and re-tuned.
SCHEMA_VERSION = 2
ENV_VAR = "REPRO_TORCH_TUNE_CACHE"

Block = Union[int, tuple]


def default_cache_dir() -> Path:
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    base = os.environ.get("XDG_CACHE_HOME")
    root = Path(base) if base else Path.home() / ".cache"
    return root / "repro-torch-tune"


def current_backend(device=None) -> str:
    """Device kind of ``device`` (a ``torch.device``, a string, or
    ``None`` for the port's default: the card when there is one) — the
    per-platform component of every tuning key: the card's
    ``torch.cuda.get_device_name()`` (e.g. ``NVIDIA H100 80GB HBM3``),
    or ``"cpu"``."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device).replace("|", "/")


@dataclasses.dataclass(frozen=True)
class TuningKey:
    """Everything that changes the optimal block shape."""

    # Kernel family: the rank-generic plan layer keys as
    # "fused_stencil1d" / "fused_stencil2d" / "fused_stencil3d"
    # (StencilPlan.tuning_key); the standalone 1-D kernels as
    # "xcorr1d" and "conv1d_depthwise".
    kernel: str
    # Strategy id from the plan layer's strategy_sid derivation — e.g.
    # "swc", "swc_stream:sy", "tc:f2:b4", "auto:sauto:fauto" — or
    # "baseline"/"pointwise"/"elementwise" for the 1-D kernels.
    strategy: str
    domain: tuple[int, ...]  # interior extents
    radii: tuple[int, ...]  # stencil radii (halo widths) per axis
    n_f: int  # input fields
    n_out: int  # output fields
    dtype: str  # e.g. "float32"
    backend: str  # device kind (per-platform tuning, the paper's point)

    @property
    def cache_id(self) -> str:
        return "|".join(
            (
                self.kernel,
                self.strategy,
                "x".join(map(str, self.domain)),
                "x".join(map(str, self.radii)),
                str(self.n_f),
                str(self.n_out),
                self.dtype,
                self.backend,
            )
        )


@dataclasses.dataclass
class TuningRecord:
    """One tuning outcome: the winning block (plus, for joint searches,
    the winning temporal-fusion depth, explicit-streaming flag, and —
    for cross-strategy ``"auto"`` keys — the resolved strategy) and the
    full timing table (µs per call, keyed by the candidate's string
    form) for inspection.

    ``stream``/``strategy_resolved`` are what a warm cache hit needs to
    reproduce the full lowering decision without re-measuring: before
    schema v2 the streaming flag lived only in the candidate object and
    was silently dropped on the persisted path.
    """

    block: Block
    timings_us: dict[str, float]
    source: str  # "measured" | "model" | "fallback"
    schema: int = SCHEMA_VERSION
    created: float = 0.0  # unix timestamp
    fuse_steps: int = 1  # winning temporal depth (1 for pure-block keys)
    stream: bool = False  # winning explicit-streaming flag (swc_stream)
    # Strategy the winning candidate lowers through ("hwc" | "swc" |
    # "swc_stream" | "tc") — load-bearing for cross-strategy "auto" keys,
    # informational for per-strategy keys (where the key pins it), and
    # empty for the 1-D kernels whose candidates carry no strategy.
    strategy_resolved: str = ""
    # Failed rows of the timing table: candidate label → error summary
    # for every candidate whose measurement raised (injected compile
    # failure, a launch the card refused, non-finite output). Re-tunes skip
    # these known-bad candidates instead of re-launching them; the
    # field is additive, so pre-existing records parse with no failures.
    failed: dict[str, str] = dataclasses.field(default_factory=dict)
    # Element-wise unroll factor of the winning configuration. Additive
    # like ``failed``: the unroll axis joins the KEY (:u{N}), and the
    # record carries it so ``plan_from_record`` is a left inverse of
    # ``StencilPlan.tuning_key`` for unrolled plans. Records without it
    # parse as unroll=1, matching their unmarked keys.
    unroll: int = 1

    def to_json(self) -> dict:
        blk = list(self.block) if isinstance(self.block, tuple) else self.block
        return {
            "block": blk,
            "timings_us": self.timings_us,
            "source": self.source,
            "schema": self.schema,
            "created": self.created,
            "fuse_steps": self.fuse_steps,
            "stream": self.stream,
            "strategy_resolved": self.strategy_resolved,
            "failed": self.failed,
            "unroll": self.unroll,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TuningRecord":
        blk = d["block"]
        if isinstance(blk, list):
            blk = tuple(blk)
        return cls(
            block=blk,
            timings_us=dict(d.get("timings_us", {})),
            source=d.get("source", "measured"),
            schema=int(d.get("schema", -1)),
            created=float(d.get("created", 0.0)),
            fuse_steps=int(d.get("fuse_steps", 1)),
            stream=bool(d.get("stream", False)),
            strategy_resolved=str(d.get("strategy_resolved", "")),
            failed=dict(d.get("failed", {})),
            unroll=int(d.get("unroll", 1)),
        )

    @property
    def resolved_strategy(self) -> str:
        """Concrete strategy this record lowers to — the ONE place the
        empty-``strategy_resolved`` fallback lives (records written by
        strategy-less searches imply ``swc``/``swc_stream`` from the
        stream flag)."""
        return self.strategy_resolved or (
            "swc_stream" if self.stream else "swc"
        )

    @property
    def winner_label(self) -> str:
        """Label of the winning candidate in :attr:`timings_us` —
        derived by the same :func:`candidate_label` the measurement
        loop writes, so display code can mark the winner row."""
        return candidate_label(
            self.block, self.fuse_steps, self.stream,
            self.strategy_resolved,
        )


def format_block(block: Block) -> str:
    if isinstance(block, tuple):
        return "x".join(map(str, block))
    return str(block)


def candidate_label(
    block: Block,
    fuse_steps: int = 1,
    stream: bool = False,
    strategy: str = "",
) -> str:
    """Timing-table label for one tuning candidate/record: the block,
    suffixed with the temporal depth when a joint search mixes depths
    and a strategy marker when it mixes strategies (a pipelined, a
    streamed and a tensor-core candidate may share a block): ``:s`` for
    streaming, ``:tc`` for the tensor-core regime; ``hwc`` for the plain
    PyTorch baseline, which has no meaningful block."""
    if strategy == "hwc":
        return "hwc"
    label = format_block(block)
    if fuse_steps != 1:
        label += f"@f{fuse_steps}"
    if stream:
        label += ":s"
    if strategy == "tc":
        label += ":tc"
    return label


class TuningCache:
    """In-memory view over the persistent JSON store."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.dir = Path(path) if path is not None else default_cache_dir()
        self.file = self.dir / "cache.json"
        self._mem: dict[str, TuningRecord] | None = None

    # -- persistence --------------------------------------------------------

    def _read_disk(self) -> dict[str, TuningRecord]:
        try:
            text = self.file.read_text()
        except OSError:
            return {}  # no cache yet: cold start, not corruption
        try:
            raw = json.loads(text)
        except ValueError:
            self._quarantine_corrupt("unparseable JSON")
            return {}
        records = raw.get("records") if isinstance(raw, dict) else None
        if not isinstance(records, dict):
            # Parseable JSON but not our layout (foreign or truncated-
            # then-valid content): same quarantine, same re-tune.
            self._quarantine_corrupt("not a tuning-cache document")
            return {}
        out: dict[str, TuningRecord] = {}
        for key, rec in records.items():
            try:
                parsed = TuningRecord.from_json(rec)
            except (KeyError, TypeError, ValueError, AttributeError):
                continue
            if parsed.schema != SCHEMA_VERSION:
                continue  # schema bump invalidates old records
            out[key] = parsed
        return out

    def _quarantine_corrupt(self, reason: str) -> None:
        """Move a corrupt ``cache.json`` aside (``cache.json.corrupt``,
        numbered if that exists) instead of silently shadowing it with
        an empty view: the bad bytes stay inspectable, the next write
        starts from a clean file, and every record is re-tuned rather
        than half-trusted. Losing the rename race to a concurrent
        process is fine — someone quarantined it."""
        for n in range(100):
            suffix = ".corrupt" if n == 0 else f".corrupt.{n}"
            target = self.file.with_name(self.file.name + suffix)
            if target.exists():
                continue
            try:
                os.replace(self.file, target)
            except OSError:
                return  # already quarantined (or unlinked) by a peer
            log.warning(
                "quarantined corrupt tuning cache %s -> %s (%s); "
                "records will be re-tuned", self.file, target.name, reason,
            )
            return
        # 100 corpses: stop hoarding, drop the bytes.
        try:
            os.unlink(self.file)
        except OSError:
            pass

    def _write_disk(self, records: dict[str, TuningRecord]) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        payload = json.dumps(
            {
                "schema": SCHEMA_VERSION,
                "records": {k: r.to_json() for k, r in records.items()},
            },
            indent=1,
            sort_keys=True,
        )
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(payload)
            os.replace(tmp, self.file)
        # repolint: allow[broad-except] — tmp-file cleanup, re-raised below
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _records(self) -> dict[str, TuningRecord]:
        if self._mem is None:
            self._mem = self._read_disk()
        return self._mem

    # -- public API ---------------------------------------------------------

    def get(self, key: TuningKey) -> TuningRecord | None:
        return self._records().get(key.cache_id)

    @contextlib.contextmanager
    def _locked(self) -> Iterator[None]:
        """Advisory exclusive lock serializing read-merge-write cycles
        across processes (posix only; elsewhere the merge alone bounds
        the race to a re-measure)."""
        if fcntl is None:
            yield
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        with open(self.dir / "cache.lock", "w") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)

    def put(self, key: TuningKey, record: TuningRecord) -> None:
        if not record.created:
            record.created = time.time()
        # Under the lock, disk wins for every key except the one being
        # written now: every earlier put already wrote through, and our
        # in-memory view may be staler than another process's upgrade.
        with self._locked():
            merged = self._read_disk()
            merged[key.cache_id] = record
            self._mem = merged
            self._write_disk(merged)

    def items(self) -> dict[str, TuningRecord]:
        return dict(self._records())

    def clear(self) -> None:
        self._mem = {}
        try:
            self.file.unlink()
        except OSError:
            pass
