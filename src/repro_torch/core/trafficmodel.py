"""Modeled device-memory traffic (the port's own copy of
``repro.core.trafficmodel``; numpy-free, no JAX): per-rank bytes of a
language model's train, prefill and decode step, and the traffic and
redundant work of the stencil's temporal fusion and slowest-axis
streaming.

The model half (:func:`modeled_hbm_bytes`) is the reference's analytic
count of what one fused step moves through device memory per rank,
term for term: parameters (f32 master read and write, the bf16 cast
written and read), AdamW's moments, gradients, remat-saved activations
and logits for training; one bf16 read of the parameters and the
activations at each layer boundary for prefill; the active parameters
and the decode cache (read whole, one slot written) for decode.
Parameters are taken as cut over ``model`` (and over the data ranks
under FSDP), activations over the data ranks on tokens, their hidden
dims over ``model`` where the rules cut them. The dry run
(``launch.dryrun``) reads it as the memory term of each cell's
roofline.

A ``fuse_steps``-deep launch stages each tile with a ``radii *
fuse_steps`` halo, writes the interior once and advances that many time
steps; its intermediate sweeps recompute the halo shells the unfused
schedule would have read back. A streaming launch reads each column's
stream extent once, carrying the stream-axis halo on chip.
``chip_smoke.py`` prints these figures beside the temporal and stream
kernel rows; the tuner's Hopper cost model (``repro_torch.tuning.
costmodel``) scores tiles with them over the card's data-sheet rates
(:data:`CARD_RATES`, :data:`TC_RATES`, :func:`card_rates`).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.models.config import ModelConfig


def _act_bytes_per_token_layer(cfg: ModelConfig, model_ways: int) -> float:
    """Remat-saved bytes per token per layer (bf16), TP-sharded dims ÷M."""
    d = cfg.d_model
    m = model_ways
    if cfg.family == "ssm":
        dv = cfg.d_inner
        # in_proj out (2dv+2gn+h)/M, conv out, ssd y, out_proj in
        per = (2 * dv + 2 * cfg.ssm_n_groups * cfg.ssm_state) / m * 3 + d
    elif cfg.hybrid_pattern:
        w = cfg.lru_width or d
        per = (3 * w / m + d) * 2 / 3 + (  # rec blocks (2 of 3)
            (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd / m + d
            + 2 * cfg.d_ff / m
        ) / 3
    else:
        ff = cfg.d_ff_expert * cfg.top_k if cfg.family == "moe" else cfg.d_ff
        per = (
            (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd / m  # qkv
            + cfg.n_heads * cfg.hd / m  # attn out
            + 2 * ff / m  # gate/up
            + 2 * d  # residual stream saves
        )
    return per * 2.0  # bf16


def modeled_hbm_bytes(
    cfg: ModelConfig,
    kind: str,
    seq: int,
    global_batch: int,
    *,
    model_ways: int,
    dp_ways: int,
    fsdp: bool = False,
) -> float:
    """Per-rank device-memory bytes for one step of ``kind`` (``"train"``,
    ``"prefill"`` or ``"decode"``) at ``global_batch`` rows of ``seq``
    tokens, over ``model_ways`` x ``dp_ways`` ranks."""
    n_params = cfg.n_params()
    n_active = cfg.n_active_params()
    p_shard = n_params / model_ways / (dp_ways if fsdp else 1)
    eff_seq = cfg.max_target_len if cfg.is_encdec and kind != "prefill" else seq
    tokens_chip = global_batch * eff_seq / dp_ways / max(
        1, (model_ways if kind != "decode" else 1)
    )
    # sequence is model-sharded (SP) in train/prefill; decode has 1 token.
    if kind == "decode":
        tokens_chip = max(global_batch / dp_ways, 1.0)

    n_layers = cfg.n_layers + cfg.n_encoder_layers

    if kind == "train":
        param_traffic = p_shard * (4 + 4 + 2 + 2)  # f32 r/w + bf16 w/r
        opt_traffic = p_shard * 4 * 4  # mu, nu r+w
        grad_traffic = p_shard * 4 * 2
        act = tokens_chip * n_layers * _act_bytes_per_token_layer(
            cfg, model_ways
        ) * 2.0  # write fwd + read bwd
        logits = tokens_chip * (cfg.vocab / model_ways) * 2 * 3
        return param_traffic + opt_traffic + grad_traffic + act + logits
    if kind == "prefill":
        param_traffic = p_shard * 2  # bf16-equivalent read
        act = tokens_chip * n_layers * _act_bytes_per_token_layer(
            cfg, model_ways
        )
        return param_traffic + act
    # decode
    p_active_shard = n_active / model_ways
    param_traffic = p_active_shard * 2  # bf16 read per token
    cache = _decode_cache_bytes(cfg, seq, global_batch, dp_ways, model_ways)
    return param_traffic + cache


def _decode_cache_bytes(
    cfg: ModelConfig, seq: int, global_batch: int, dp_ways: int,
    model_ways: int,
) -> float:
    b_chip = max(global_batch / dp_ways, 1.0)
    if cfg.family == "ssm":
        dv = cfg.d_inner
        state = (
            cfg.ssm_n_heads * cfg.ssm_state * cfg.ssm_head_dim
            + (cfg.ssm_conv_kernel - 1)
            * (dv + 2 * cfg.ssm_n_groups * cfg.ssm_state)
        )
        shard = model_ways  # heads/channels sharded
        return b_chip * cfg.n_layers * state / shard * 4 * 2  # f32 r+w
    if cfg.hybrid_pattern:
        n_rec = cfg.n_layers - cfg.n_layers // cfg.hybrid_pattern
        n_att = cfg.n_layers // cfg.hybrid_pattern
        w = cfg.lru_width or cfg.d_model
        rec = b_chip * n_rec * (
            w + (cfg.ssm_conv_kernel - 1) * w
        ) / model_ways * 4 * 2
        win = min(cfg.local_window, seq)
        att = b_chip * n_att * win * cfg.n_kv_heads * cfg.hd * 2
        return rec + att
    cache_len = (
        min(cfg.sliding_window, seq) if cfg.sliding_window else seq
    )
    kv_shard = model_ways if cfg.n_kv_heads % model_ways == 0 else 1
    return (
        b_chip * cfg.n_layers * cache_len * 2  # k and v
        * cfg.n_kv_heads * cfg.hd / kv_shard * 2  # bf16
    )


# ---------------------------------------------------------------------------
# Stencil temporal-fusion traffic (the fused-kernel bandwidth lever).
# ---------------------------------------------------------------------------


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


def stencil_batched_hbm_bytes_per_member_step(
    domain: Sequence[int],
    block: Sequence[int],
    radii: Sequence[int],
    n_f: int,
    n_out: int,
    itemsize: int,
    *,
    batch: int = 1,
    fuse_steps: int = 1,
    stream: bool = False,
    segments: int = 1,
) -> float:
    """Modeled device-memory bytes per ENSEMBLE MEMBER per time step of
    a batched launch serving ``batch`` members (port of the reference's).

    The field and halo traffic is per member (the byte functions above).
    The reference's TPU-calibrated per-launch constant does not carry
    over and no launch cost is modeled, so the per-member bytes equal
    the unbatched ones. ``stream`` selects the streaming model, with its
    ``segments``.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if stream:
        member = stencil_stream_hbm_bytes_per_step(
            domain, block, radii, n_f, n_out, itemsize, fuse_steps,
            segments=segments,
        )
    else:
        member = stencil_hbm_bytes_per_step(
            domain, block, radii, n_f, n_out, itemsize, fuse_steps
        )
    return member


def stencil_traffic_reduction(
    domain: Sequence[int],
    radii: Sequence[int],
    n_f: int,
    n_out: int,
    itemsize: int,
    *,
    block_base: Sequence[int],
    block_fused: Sequence[int],
    fuse_steps: int,
    stream: bool = False,
) -> float:
    """Modeled per-step traffic reduction of a fused configuration over
    its depth-1 baseline (> 1: the fused plan moves less); ``stream``
    models both sides with the streaming byte function."""
    bytes_fn = (
        stencil_stream_hbm_bytes_per_step
        if stream
        else stencil_hbm_bytes_per_step
    )
    base = bytes_fn(domain, block_base, radii, n_f, n_out, itemsize, 1)
    fused = bytes_fn(
        domain, block_fused, radii, n_f, n_out, itemsize, fuse_steps
    )
    return base / fused


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


# Data-sheet rates of the cards, keyed by a substring of
# ``torch.cuda.get_device_name()`` (the first match wins, so the
# specific names come first): (memory bytes/s, non-tensor f32 FLOP/s,
# non-tensor f64 FLOP/s). Copied from ``chip_smoke.py``'s table; each
# is the vendor's data-sheet figure, not a measurement.
CARD_RATES: dict[str, tuple[float, float, float]] = {
    "H100 PCIe": (2.0e12, 51e12, 26e12),
    "H100 NVL": (3.9e12, 60e12, 30e12),
    "H100": (3.35e12, 67e12, 34e12),  # SXM5
    "H200": (4.8e12, 67e12, 34e12),
}
# Tensor-core data-sheet rates of the tc routes (SXM): the bf16 MMA; f32
# fields contract on the f64 MMA.
TC_RATES: dict[str, float] = {"bfloat16": 989e12, "float32": 67e12}
# The rates a backend without an entry is modeled at (the CPU's model-
# only resolution, an unlisted card): the H100 SXM5's, so the ranking of
# a CPU run is the one the card's model would give.
DEFAULT_CARD = "H100"


def card_rates(backend: str | None = None) -> tuple[float, float, float]:
    """(memory B/s, f32 FLOP/s, f64 FLOP/s) of ``backend`` (a device
    name, ``"cpu"`` or None: :data:`DEFAULT_CARD`'s)."""
    for key, rates in CARD_RATES.items():
        if backend and key in backend:
            return rates
    return CARD_RATES[DEFAULT_CARD]
