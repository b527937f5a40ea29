"""Persistent tile, depth and strategy tuning on the card (port of
``repro.tuning``; paper Sec. 5.1, Fig. 14).

Layers:

* ``costmodel`` — the Hopper cost model: the planner as the static
  filter, a score in modeled ms per step, CUDA-event timing;
* ``cache``     — the persistent per-device JSON store
  (``$REPRO_TORCH_TUNE_CACHE`` or ``~/.cache/repro-torch-tune/``),
  schema-versioned, keyed by ``torch.cuda.get_device_name()`` (``cpu``
  for a CPU tensor);
* ``session``   — model-rank → measure the top k → record, with a
  cache-hit fast path; the ``"auto"`` resolvers of ``block``,
  ``fuse_steps``, ``strategy``, ``block_size`` and ``block_seq`` live
  here;
* ``cli``       — ``python -m repro_torch.tuning warm|show|clear``.
"""
from repro_torch.tuning.cache import (  # noqa: F401
    SCHEMA_VERSION,
    TuningCache,
    TuningKey,
    TuningRecord,
    candidate_label,
    current_backend,
    default_cache_dir,
    format_block,
)
from repro_torch.tuning.costmodel import (  # noqa: F401
    Candidate,
    Candidate1D,
    axis_tile_options,
    enumerate_candidates_1d,
    enumerate_candidates_nd,
    enumerate_cross_strategy_nd,
    halo_overhead,
    hwc_candidate,
    plan_score,
    time_candidate,
)
from repro_torch.tuning.session import (  # noqa: F401
    TuningSession,
    auto_block_conv1d,
    auto_block_nd,
    auto_block_xcorr1d,
    auto_fuse_nd,
    auto_strategy_nd,
    default_session,
    enable_auto,
    fused_nd_key,
    lookup_fused_nd,
)
from repro_torch.tuning.shapes import warm_model_kernels  # noqa: F401
