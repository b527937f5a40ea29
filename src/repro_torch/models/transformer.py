"""Decoder-only transformer, dense and VLM families (port of
``repro.models.transformer``): qwen2.5-3b/14b, gemma-2b, llama3-8b and
qwen2-vl-7b (M-RoPE, the vision frontend stubbed by ``patch_embeds``).
The MoE FFN (``models/moe.py``) is not ported yet (ROADMAP A13).

Also the helpers mamba2 shares: ``cast_params``, ``scan_layers`` and
the remat policy (:func:`remat_body`).

Parameters are plain nested dicts of tensors whose blocks are stacked
along a leading layer axis, as in the reference; the layer loop is
:func:`scan_layers`. The reference's sharding constraints have no
counterpart on one card. Every op runs in plain PyTorch: the reference
computes attention, RoPE and the MLPs in ``jnp``, outside any Pallas
kernel, so this path launches none of the port's CUDA kernels.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import as_dtype, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.tree import (
    tree_leaves_with_path,
    tree_map,
    tree_map_with_path,
)

Params = dict[str, Any]
f32 = torch.float32

_KEEP_F32 = ("ln1", "ln2", "q_norm", "k_norm", "final_norm", "ssm_norm",
             "A_log", "dt_bias", "a_param")


def cast_params(tree: Params, dtype: str | torch.dtype) -> Params:
    """Mixed precision: matmul weights in compute dtype, norms/gates f32
    (a leaf whose key contains one of ``_KEEP_F32`` keeps its dtype)."""
    dt = as_dtype(dtype)

    def one(name: str, leaf):
        if isinstance(leaf, dict):
            return {k: one(k, v) for k, v in leaf.items()}
        if any(k in name for k in _KEEP_F32):
            return leaf
        return leaf.to(dt)

    return {k: one(k, v) for k, v in tree.items()}


def scan_layers(body: Callable, x, stacked):
    """The reference's ``lax.scan`` over stacked layer params as a loop
    over the layer index: ``x, y_i = body(x, stacked[i])``; returns
    ``x`` and the ``y_i`` stacked along a new leading axis.

    Each stacked leaf is cut into its layers once (``unbind``), so under
    autograd its gradient is stacked once from the layers' gradients, as
    the scan's cotangent is; indexing each layer apart would add a
    full-size zero-filled gradient into it once a layer."""
    leaves = tree_leaves_with_path(stacked)
    layers = {path: leaf.unbind(0) for path, leaf in leaves}
    ys = []
    for i in range(leaves[0][1].shape[0]):
        x, y = body(x, tree_map_with_path(lambda path, _: layers[path][i],
                                          stacked))
        ys.append(y)
    return x, tree_map(
        lambda *leaves: torch.stack([torch.as_tensor(v) for v in leaves]),
        *ys,
    )


def _save_dots(ctx, op, *args, **kwargs):
    """Selective remat's policy: keep the outputs of plain matrix
    products (``aten.mm``: the projections), recompute the rest. The
    reference's ``dots_with_no_batch_dims_saveable``; batched einsums
    (``bmm``: attention, the SSD) are recomputed, as there."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_body(block: Callable, remat: str) -> Callable:
    """``block`` as one layer of the forward under ``cfg.remat``: with
    grad mode on and ``remat`` other than ``"none"``, under
    ``torch.utils.checkpoint`` (non-reentrant), so the backward
    recomputes the layer from its input, as the reference's
    ``jax.checkpoint`` does: ``"selective"`` keeps the ``aten.mm``
    outputs (:func:`_save_dots`), ``"full"`` nothing. Under ``no_grad``
    (serving) the layer runs as it is."""
    if remat == "none" or not torch.is_grad_enabled():
        return block
    if remat == "full":
        return functools.partial(checkpoint, block, use_reentrant=False)
    context = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
    return functools.partial(checkpoint, block, use_reentrant=False,
                             context_fn=context)


# --- init --------------------------------------------------------------------


def _block_shapes(cfg: ModelConfig, n_layers: int) -> dict[str, tuple]:
    """Each stacked block leaf's shape, in the reference's draw order."""
    d, hd, h, g = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    shapes = {
        "ln1": (n_layers, d),
        "ln2": (n_layers, d),
        "wq": (n_layers, d, h * hd),
        "wk": (n_layers, d, g * hd),
        "wv": (n_layers, d, g * hd),
        "wo": (n_layers, h * hd, d),
    }
    if cfg.qkv_bias:
        shapes.update(bq=(n_layers, h * hd), bk=(n_layers, g * hd),
                      bv=(n_layers, g * hd))
    if cfg.qk_norm:
        shapes.update(q_norm=(n_layers, hd), k_norm=(n_layers, hd))
    if cfg.family == "moe":
        raise _moe_not_ported()
    shapes.update(w_gate=(n_layers, d, cfg.d_ff), w_up=(n_layers, d, cfg.d_ff),
                  w_down=(n_layers, cfg.d_ff, d))
    return shapes


_DRAWN = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _moe_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "the MoE FFN is not ported yet: ROADMAP A13 (models/moe.py)")


def init_block_params(cfg: ModelConfig, gen: torch.Generator,
                      n_layers: int) -> Params:
    """Stacked block params with leading (n_layers,) axis: the
    projections from ``dense_init``, norms and biases zero."""
    return {
        k: (L.dense_init(gen, s) if k in _DRAWN
            else torch.zeros(s, device=gen.device))
        for k, s in _block_shapes(cfg, n_layers).items()
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> Params:
    """Random init (the reference's shapes, scales and optional leaves:
    ``bq/bk/bv``, ``q_norm/k_norm``, no ``unembed`` when tied) from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card by
    default; it raises without one unless ``device="cpu"``). The draws
    differ from ``jax.random``'s: to compare with the reference, carry
    its parameters across with ``convert.model_params_from_numpy``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Params = {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model),
                              scale=cfg.d_model**-0.5),
        "blocks": init_block_params(cfg, gen, cfg.n_layers),
        "final_norm": torch.zeros((cfg.d_model,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.vocab))
    return params


def abstract_params(cfg: ModelConfig) -> Params:
    """The tree :func:`init_params` makes, as float32 tensors on the
    ``meta`` device (shapes, no storage): the reference's
    ``launch.specs.abstract_params``, which the sharding rules read."""

    def meta(shape):
        return torch.empty(shape, dtype=f32, device="meta")

    params: Params = {
        "embed": meta((cfg.vocab, cfg.d_model)),
        "blocks": {k: meta(s) for k, s in
                   _block_shapes(cfg, cfg.n_layers).items()},
        "final_norm": meta((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = meta((cfg.d_model, cfg.vocab))
    return params


# --- attention sub-block -----------------------------------------------------


def _qkv(x, blk, cfg: ModelConfig):
    b, s, _ = x.shape
    q = x @ blk["wq"]
    k = x @ blk["wk"]
    v = x @ blk["wv"]
    if cfg.qkv_bias:
        q = q + blk["bq"]
        k = k + blk["bk"]
        v = v + blk["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, blk["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, blk["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_block(x: torch.Tensor, blk: Params, cfg: ModelConfig,
                    cos, sin) -> torch.Tensor:
    """Training/prefill self-attention with RoPE and GQA, dispatched as
    the reference's: materialised at s ≤ 2048; above it the streaming
    form on chunks of 1024, or banded (KV chunk = window) when a
    sliding window divides s."""
    q, k, v = _qkv(x, blk, cfg)
    if cfg.rope_style != "none":
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    b, s = x.shape[:2]
    win = cfg.sliding_window
    if win is not None and win >= s:
        win = None  # window covers the whole sequence → plain causal
    unroll = cfg.analysis_unroll or cfg.attn_block_skip
    if s > 2048:
        banded = win is not None and s % win == 0
        out = L.chunked_attention(
            q, k, v, causal=True, window=win,
            q_chunk=min(1024, win) if banded else 1024,
            kv_chunk=win if banded else 1024,
            unroll=unroll, skip_masked_blocks=cfg.attn_block_skip,
        )
    else:
        out = L.attention(q, k, v, causal=True, window=win)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ blk["wo"]


def ffn_block(x, blk, cfg: ModelConfig):
    """(the FFN's output, its aux loss: zero for the dense MLP)."""
    if cfg.family == "moe":
        raise _moe_not_ported()
    return L.gated_mlp(x, blk["w_gate"], blk["w_up"], blk["w_down"],
                       cfg.mlp), torch.zeros((), dtype=f32, device=x.device)


def decoder_block(x, blk, cfg: ModelConfig, cos, sin):
    h = x + attention_block(L.rms_norm(x, blk["ln1"], cfg.norm_eps), blk,
                            cfg, cos, sin)
    ff, aux = ffn_block(L.rms_norm(h, blk["ln2"], cfg.norm_eps), blk, cfg)
    return h + ff, aux


# --- forward -----------------------------------------------------------------


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor | None, b: int,
                 s: int, device: torch.device):
    if cfg.rope_style == "none":
        return None, None
    if positions is None:
        positions = torch.arange(s, device=device)[None].expand(b, s)
    if cfg.rope_style == "mrope":
        if positions.dim() == 2:  # text-only: all three streams identical
            positions = positions[None].expand(3, b, s)
        return L.mrope_cos_sin(positions, cfg.hd, cfg.rope_theta,
                               cfg.mrope_sections)
    return L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)


def embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embedding in ``cfg.dtype``; for the VLM family the stubbed
    vision frontend's ``patch_embeds`` (b, n_patches, d) REPLACE the
    first n_patches positions; gemma scales by √d (in the compute
    dtype)."""
    dtype = as_dtype(cfg.dtype)
    x = params["embed"][tokens].to(dtype)
    if cfg.family == "vlm" and patch_embeds is not None:
        n_p = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(dtype), x[:, n_p:]], dim=1)
    if cfg.family == "dense" and cfg.arch_id.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dtype, device=x.device)
    return x


def _unembed(params: Params, cfg: ModelConfig, x: torch.Tensor):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    unembed = params.get("unembed")
    if unembed is None:
        unembed = params["embed"].T
    return x @ unembed.to(x.dtype)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            patch_embeds: torch.Tensor | None = None):
    """Full forward pass → (logits (b, s, vocab) in ``cfg.dtype``, the
    summed MoE aux loss: zero here). ``positions`` (b, s), or (3, b, s)
    for M-RoPE, default to 0..s-1. Under ``cfg.remat`` each layer runs
    through :func:`remat_body`."""
    dtype = as_dtype(cfg.dtype)
    b, s = tokens.shape
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    cos, sin = _rope_tables(cfg, positions, b, s, tokens.device)

    def block(xc, blk):
        return decoder_block(xc, cast_params(blk, dtype), cfg, cos, sin)

    x, auxes = scan_layers(remat_body(block, cfg.remat), x, params["blocks"])
    return _unembed(params, cfg, x), auxes.sum()


def lm_loss(params: Params, cfg: ModelConfig, batch: dict):
    """(next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` under the optional ``loss_mask``, plus the
    router's weighted aux loss; {"xent", "aux"}). ``batch`` may carry
    ``positions`` and ``patch_embeds``."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          positions=batch.get("positions"),
                          patch_embeds=batch.get("patch_embeds"))
    xent = L.token_xent(logits, batch["labels"], batch.get("loss_mask"))
    loss = xent + cfg.router_aux_weight * aux
    return loss, {"xent": xent, "aux": aux}


# --- decode ------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: str | torch.dtype | None = None,
                      device: str | torch.device | None = None
                      ) -> L.KVCache:
    """An empty KV cache on ``device`` (the card by default), bf16 for a
    bf16 config; sliding-window configs get a ring of ``sliding_window``
    slots, so decode stays O(w) at any context."""
    dev = resolve_device(device)
    dt = as_dtype(dtype or cfg.dtype)
    cache_len = (min(cfg.sliding_window, max_len) if cfg.sliding_window
                 else max_len)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return L.KVCache(
        k=torch.zeros(shape, dtype=dt, device=dev),
        v=torch.zeros(shape, dtype=dt, device=dev),
        length=torch.zeros((), dtype=torch.int32, device=dev),
    )


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: L.KVCache):
    """One decode step: ``tokens`` (b, 1) at position ``cache.length``
    written into its slot (the ring's ``length mod size`` for a window,
    else ``length``, held to the last slot when full as the reference's
    ``dynamic_update_slice`` is), attended against the valid entries →
    (logits (b, vocab) in ``cfg.dtype``, the next cache). Runs on the
    device without reading the length back to the host."""
    dtype = as_dtype(cfg.dtype)
    b = tokens.shape[0]
    x = embed_inputs(params, cfg, tokens)
    length = cache.length.long()
    cos, sin = _rope_tables(cfg, length.expand(b, 1), b, 1, tokens.device)

    size = cache.k.shape[2]
    ring = cfg.sliding_window is not None and size <= cfg.sliding_window
    slot = (length % size if ring else length.clamp(max=size - 1)).view(1)
    valid = length.clamp(max=size - 1) + 1 if ring else length + 1

    def body(carry, scanned):
        (xc,) = carry
        blk, k_cache, v_cache = scanned
        blk = cast_params(blk, dtype)
        q, k, v = _qkv(L.rms_norm(xc, blk["ln1"], cfg.norm_eps), blk, cfg)
        if cfg.rope_style != "none":
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
        k_cache = k_cache.index_copy(1, slot, k.to(k_cache.dtype))
        v_cache = v_cache.index_copy(1, slot, v.to(v_cache.dtype))
        # Ring eviction already enforces the window; absolute RoPE keeps
        # scores position-correct regardless of slot order.
        out = L.decode_attention(q, k_cache, v_cache, valid,
                                 window=None if ring else cfg.sliding_window)
        h = xc + out.reshape(b, 1, cfg.n_heads * cfg.hd) @ blk["wo"]
        ff, _ = ffn_block(L.rms_norm(h, blk["ln2"], cfg.norm_eps), blk, cfg)
        return (h + ff,), (k_cache, v_cache)

    (x,), (k_new, v_new) = scan_layers(
        body, (x,), (params["blocks"], cache.k, cache.v))
    logits = _unembed(params, cfg, x)
    return logits[:, 0], L.KVCache(k_new, v_new, cache.length + 1)
