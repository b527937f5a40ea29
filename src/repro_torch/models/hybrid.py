"""RecurrentGemma / Griffin hybrid family (recurrentgemma-9b), port of
``repro.models.hybrid``.

Layer pattern 1:2: every third block is local (sliding-window, MQA)
attention, the others are recurrent blocks: a temporal conv (k = 4, the
plain causal conv, as the reference's ``rec_block`` calls it) followed
by the RG-LRU gated linear recurrence (arXiv:2402.19427):

    r_t = σ(W_a x_t + b_a)                        (recurrence gate)
    i_t = σ(W_x x_t + b_x)                        (input gate)
    log a_t = −c · softplus(Λ) · r_t              (c = 8)
    h_t = a_t · h_{t−1} + √(1 − a_t²) · (i_t ⊙ x_t)

Training and prefill evaluate the recurrence as a log-depth scan on the
reference's ``combine`` (:func:`linear_scan`: ⌈log2 l⌉ doubling rounds
of elementwise passes, where the reference calls
``lax.associative_scan``); decode carries (h, conv window) as O(1)
state, and the attention a ring of ``local_window`` slots, so the cache
does not grow with the context.

Layers are stacked as super-blocks of (rec, rec, attn), run by
``scan_layers`` under the remat policy, plus an unstacked tail of
recurrent blocks for ``n_layers % 3``. Every op is plain PyTorch: the
reference computes this family in ``jnp`` outside any Pallas kernel.
A recurrent block's conv and RG-LRU (gates and scan) run under the
``torch.profiler`` ranges ``hybrid.conv`` and ``hybrid.rg_lru``.

Tensor parallelism (the ``tp`` profile's ``model`` axis, installed by
``distrib.sharding.set_rules`` / ``rules_context``): the reference's
``PARAM_RULES`` cut only ``embed`` (by vocab) and ``unembed`` (on
d_model, as ``embed$`` matches it first) of this tree; its
``blocks_rec/*`` rules match no leaf, so every ``super/*`` and
``tail_rec/*`` leaf is whole on every rank. Each rank holds those
blocks, looks the tokens up vocab-parallel and takes its vocab columns
of the logits (``transformer.embed_tokens``, ``transformer.tp_logits``),
and computes every layer whole, as GSPMD does with whole leaves. The
decode cache stays in the reference's ``cache_shardings`` blocks
between steps: the RG-LRU state and conv window by width (each step
gathers a layer's blocks, computes the layer whole and keeps this
rank's width), the KV ring whole (one KV head does not split; a ring cut
by heads is gathered the same way).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch import as_dtype, resolve_device
from repro_torch.distrib import sharding as shlib
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map

Params = dict[str, Any]
f32 = torch.float32
LRU_C = 8.0


class HybridCache(NamedTuple):
    # recurrent blocks
    lru_h: torch.Tensor  # (n_rec, b, w) f32
    conv: torch.Tensor  # (n_rec, b, k-1, w) f32
    # attention blocks: a ring of the window's KV
    k: torch.Tensor  # (n_att, b, window, g, dh)
    v: torch.Tensor
    length: torch.Tensor  # () int32


def split_layers(n_layers: int, pattern: int) -> tuple[int, int, int]:
    """(n_super, n_tail_rec, n_att). Pattern 3 → (rec, rec, att) blocks."""
    n_super = n_layers // pattern
    return n_super, n_layers - n_super * pattern, n_super


# --- init ----------------------------------------------------------------------

# The recurrent block's leaves drawn by ``dense_init`` (the rest are
# constants: zeros, and Λ = 2).
_REC_DRAWN = ("w_x", "w_gate_in", "conv_w", "w_a_gate", "w_i_gate", "w_out",
              "w_g", "w_u", "w_d")


def _rec_shapes(cfg: ModelConfig, n: int) -> dict[str, tuple]:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "ln": (n, d),
        "w_x": (n, d, w),
        "w_gate_in": (n, d, w),
        "conv_w": (n, cfg.ssm_conv_kernel, w),
        "conv_b": (n, w),
        "w_a_gate": (n, w),  # diagonal gates
        "b_a_gate": (n, w),
        "w_i_gate": (n, w),
        "b_i_gate": (n, w),
        "a_param": (n, w),
        "w_out": (n, w, d),
        "ln_mlp": (n, d),
        "w_g": (n, d, cfg.d_ff),
        "w_u": (n, d, cfg.d_ff),
        "w_d": (n, cfg.d_ff, d),
    }


def init_rec_params(cfg: ModelConfig, gen: torch.Generator, n: int) -> Params:
    """``n`` stacked recurrent blocks: the projections, conv taps and
    gate weights from ``dense_init`` (fan-in the second-to-last dim, as
    the reference's: the layer count for the (n, w) gates), norms and
    biases zero, Λ = 2 (softplus(2) ≈ 2.13)."""
    dev = gen.device

    def make(name, shape):
        if name in _REC_DRAWN:
            return L.dense_init(gen, shape)
        if name == "a_param":
            return torch.full(shape, 2.0, device=dev)
        return torch.zeros(shape, device=dev)

    return {k: make(k, s) for k, s in _rec_shapes(cfg, n).items()}


def init_att_params(cfg: ModelConfig, gen: torch.Generator, n: int) -> Params:
    return tr.init_block_params(cfg, gen, n)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> Params:
    """Random init (the reference's tree, shapes and scales) from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card by
    default; it raises without one unless ``device="cpu"``). The draws
    differ from ``jax.random``'s: to compare with the reference, carry
    its parameters across with ``convert.model_params_from_numpy``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_super, n_tail, _ = split_layers(cfg.n_layers, cfg.hybrid_pattern)
    return {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model),
                              scale=cfg.d_model**-0.5),
        "super": {
            "rec1": init_rec_params(cfg, gen, n_super),
            "rec2": init_rec_params(cfg, gen, n_super),
            "att": init_att_params(cfg, gen, n_super),
        },
        "tail_rec": init_rec_params(cfg, gen, n_tail),
        "final_norm": torch.zeros((cfg.d_model,), device=dev),
        "unembed": L.dense_init(gen, (cfg.d_model, cfg.vocab)),
    }


def abstract_params(cfg: ModelConfig) -> Params:
    """The tree :func:`init_params` makes, as float32 tensors on the
    ``meta`` device (shapes, no storage): the reference's
    ``launch.specs.abstract_params``, which the sharding rules read."""

    def meta(shapes):
        if isinstance(shapes, dict):
            return {k: meta(s) for k, s in shapes.items()}
        return torch.empty(shapes, dtype=f32, device="meta")

    n_super, n_tail, _ = split_layers(cfg.n_layers, cfg.hybrid_pattern)
    return meta({
        "embed": (cfg.vocab, cfg.d_model),
        "super": {
            "rec1": _rec_shapes(cfg, n_super),
            "rec2": _rec_shapes(cfg, n_super),
            "att": tr._block_shapes(cfg, n_super),
        },
        "tail_rec": _rec_shapes(cfg, n_tail),
        "final_norm": (cfg.d_model,),
        "unembed": (cfg.d_model, cfg.vocab),
    })


# --- RG-LRU ------------------------------------------------------------------


def _doubling(a: torch.Tensor, b: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The inclusive scan of ``h_t = a_t h_{t∓1} + b_t`` along dim 1
    (forward, or from the end with ``reverse``) in ⌈log2 l⌉ rounds: round
    ``d`` combines each element with the one ``d`` before it (after it),
    by the reference's ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 +
    b2)``. Works on copies; no graph."""
    a, b = a.clone(), b.clone()
    n = a.shape[1]
    d = 1
    while d < n:
        head, tail = ((slice(d, None), slice(None, n - d)) if not reverse
                      else (slice(None, n - d), slice(d, None)))
        b[:, head] += a[:, head] * b[:, tail]
        if 2 * d < n:  # the last round needs no products of a
            a[:, head] *= a[:, tail].clone()
        d *= 2
    return b


class _LinearScan(torch.autograd.Function):
    """``h = linear_scan(a, b)`` with its backward the same log-depth
    scan run from the end: ``g_t = ∂L/∂h_t + a_{t+1} g_{t+1}``, then
    ``∂L/∂b = g`` and ``∂L/∂a_t = g_t h_{t−1}`` (``h_{−1} = 0``)."""

    @staticmethod
    def forward(ctx, a, b):
        h = _doubling(a, b, reverse=False)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        nxt = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = _doubling(nxt, gh, reverse=True)
        ga = torch.cat([torch.zeros_like(g[:, :1]), g[:, 1:] * h[:, :-1]],
                       dim=1)
        return ga, g


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t−1} + b_t`` over dim 1 from ``h_{−1} = 0`` (the
    reference's ``lax.associative_scan(combine, (a, b), axis=1)[1]``), in
    log depth, under autograd."""
    return _LinearScan.apply(a, b)


def rg_lru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                lam: torch.Tensor, h0: torch.Tensor | None = None):
    """The RG-LRU over (b, l, w) float32 → (y, h_last), as the reference's:
    √(1−a²) through ``expm1`` (1−a² cancels catastrophically as a → 1),
    clamped at 1e-12 so that its gradient stays finite where ``r``
    underflows to 0; a carried ``h0`` (b, w) folded in as a virtual step
    0 with a = 1."""
    log_a = -LRU_C * F.softplus(lam)[None, None, :] * r  # (b, l, w)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(-torch.expm1(2.0 * log_a), 1e-12)) \
        * (i * x)
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        gated = torch.cat([h0[:, None].to(gated.dtype), gated], dim=1)
    h = linear_scan(a, gated)
    if h0 is not None:
        h = h[:, 1:]
    return h, h[:, -1]


def _gates(uf: torch.Tensor, blk: Params):
    """(r, i) in float32 from the conv's output ``uf`` (float32)."""
    r = torch.sigmoid(uf * blk["w_a_gate"].float() + blk["b_a_gate"].float())
    i = torch.sigmoid(uf * blk["w_i_gate"].float() + blk["b_i_gate"].float())
    return r, i


def _mlp(h: torch.Tensor, blk: Params, cfg: ModelConfig) -> torch.Tensor:
    return h + L.gated_mlp(L.rms_norm(h, blk["ln_mlp"], cfg.norm_eps),
                           blk["w_g"], blk["w_u"], blk["w_d"], cfg.mlp)


def rec_block(x: torch.Tensor, blk: Params, cfg: ModelConfig) -> torch.Tensor:
    """Recurrent mixer: the plain causal conv (plus ``conv_b``) → the
    RG-LRU in float32, gated by the tanh-GELU branch; then the gated
    MLP."""
    xin = L.rms_norm(x, blk["ln"], cfg.norm_eps)
    u = xin @ blk["w_x"]  # (b, l, w)
    gate = F.gelu((xin @ blk["w_gate_in"]).float(), approximate="tanh")
    with record_function("hybrid.conv"):
        u = kref.conv1d_depthwise_causal(u, blk["conv_w"].to(u.dtype))
        u = u + blk["conv_b"].to(u.dtype)
    with record_function("hybrid.rg_lru"):
        uf = u.float()
        r, i = _gates(uf, blk)
        y, _ = rg_lru_scan(uf, r, i, blk["a_param"].float())
    y = (y * gate).to(x.dtype)
    return _mlp(x + y @ blk["w_out"], blk, cfg)


def _local(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, sliding_window=cfg.local_window)


def att_block(x: torch.Tensor, blk: Params, cfg: ModelConfig, cos, sin
              ) -> torch.Tensor:
    """The transformer's decoder block with the window ``local_window``
    (banded above 2048 positions where the window divides them)."""
    out, _ = tr.decoder_block(x, blk, _local(cfg), cos, sin)
    return out


# --- forward -----------------------------------------------------------------


class _TP(NamedTuple):
    """The installed ``model`` axis and how this rank holds ``embed`` and
    ``unembed`` (``sharding.leaf_held``: (how, dim))."""

    axis: shlib.ModelAxis
    embed: tuple
    unembed: tuple


def _tp_plan(cfg: ModelConfig) -> _TP | None:
    """None without a ``tp`` rule set on a ``model`` axis above one
    rank."""
    axis = shlib.model_axis()
    if axis is None:
        return None
    return _TP(axis, shlib.leaf_held("embed", (cfg.vocab, cfg.d_model)),
               shlib.leaf_held("unembed", (cfg.d_model, cfg.vocab)))


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           tp: _TP | None = None):
    """The embedding in the compute dtype times √d_model (gemma-style);
    vocab-parallel where ``tp`` cuts it."""
    dtype = as_dtype(cfg.dtype)
    axis = tp.axis if tp is not None and tp.embed[0] != "whole" else None
    x = tr.embed_tokens(params["embed"], tokens, dtype, axis)
    return x * torch.tensor(cfg.d_model**0.5, dtype=dtype, device=x.device)


def _unembed(params: Params, cfg: ModelConfig, x: torch.Tensor,
             tp: _TP | None = None):
    """The final norm, then the logits: this rank's vocab columns where
    ``tp`` cuts ``unembed`` (``transformer.tp_logits``)."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["unembed"].to(x.dtype)
    if tp is None or tp.unembed[0] == "whole":
        return x @ w
    return tr.tp_logits(x, w, tp.axis, rows=tp.unembed[1] == 0)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """Full forward pass → (logits (b, s, vocab) in ``cfg.dtype``, a zero
    aux loss). Each super-block runs through ``transformer.remat_body``
    under ``cfg.remat`` (the reference's ``jax.checkpoint`` with
    ``dots_with_no_batch_dims_saveable``); the tail outside it, as
    there. Under an installed ``tp`` rule set ``params`` are this rank's
    blocks and the logits its vocab columns where they are cut."""
    dtype = as_dtype(cfg.dtype)
    b, s = tokens.shape
    tp = _tp_plan(cfg)
    x = _embed(params, cfg, tokens, tp)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos, sin = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)

    def super_block(xc, sup):
        sup = tr.cast_params(sup, dtype)
        h = rec_block(xc, sup["rec1"], cfg)
        h = rec_block(h, sup["rec2"], cfg)
        return att_block(h, sup["att"], cfg, cos, sin)

    x = _layers(tr.remat_body(super_block, cfg.remat), x, params["super"])
    x = _layers(lambda xc, blk: rec_block(xc, tr.cast_params(blk, dtype), cfg),
                x, params["tail_rec"])
    logits = _unembed(params, cfg, x, tp)
    return logits, torch.zeros((), dtype=f32, device=logits.device)


def _layers(block, x, stacked):
    """``x`` through each layer of ``stacked`` (``scan_layers``; none
    when the stack is empty)."""
    if tree_leaves(stacked)[0].shape[0] == 0:
        return x
    x, _ = tr.scan_layers(lambda xc, blk: (block(xc, blk), 0.0), x, stacked)
    return x


def lm_loss(params: Params, cfg: ModelConfig, batch: dict):
    """(next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` under the optional ``loss_mask``, {"xent"});
    vocab-parallel where the logits are cut."""
    logits, _ = forward(params, cfg, batch["tokens"])
    cut = logits.shape[-1] < cfg.vocab
    loss = L.token_xent(logits, batch["labels"], batch.get("loss_mask"),
                        vocab_axis=_tp_plan(cfg).axis if cut else None)
    return loss, {"xent": loss}


# --- decode ------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device | None = None
                      ) -> HybridCache:
    """An empty decode cache on ``device`` (the card by default): the
    recurrent state and conv window in float32, a KV ring of
    ``min(local_window, max_len)`` slots in the compute dtype, so its
    size stops growing with ``max_len`` at the window. Under an
    installed ``tp`` rule set, this rank's block by the reference's
    ``cache_shardings`` rules: the state and conv window by width, the
    ring by KV heads (whole for one), the batch over the data axes."""
    dev = resolve_device(device)
    n_super, n_tail, n_att = split_layers(cfg.n_layers, cfg.hybrid_pattern)
    n_rec = 2 * n_super + n_tail
    w = cfg.lru_width or cfg.d_model
    window = min(cfg.local_window, max_len)
    kv = shlib.cache_block(
        "heads", (n_att, batch, window, cfg.n_kv_heads, cfg.hd))
    kv_dtype = as_dtype(cfg.dtype)
    return HybridCache(
        lru_h=torch.zeros(shlib.cache_block("width", (n_rec, batch, w)),
                          dtype=f32, device=dev),
        conv=torch.zeros(shlib.cache_block(
            "channels", (n_rec, batch, cfg.ssm_conv_kernel - 1, w)),
            dtype=f32, device=dev),
        k=torch.zeros(kv, dtype=kv_dtype, device=dev),
        v=torch.zeros(kv, dtype=kv_dtype, device=dev),
        length=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _joined(tp: _TP | None, t: torch.Tensor, dim: int, whole: int):
    """A cache block ``t`` joined whole along ``dim`` (``whole`` entries)
    where ``tp`` cuts it there; ``t`` itself otherwise."""
    if tp is None or t.shape[dim] == whole:
        return t
    return shlib.gather_for_compute(t, tp.axis, dim)


def _mine(tp: _TP | None, t: torch.Tensor, dim: int, held: int):
    """This rank's block (``held`` entries along ``dim``) of the whole
    ``t``."""
    if tp is None or t.shape[dim] == held:
        return t
    return t.narrow(dim, tp.axis.index * held, held)


def _rec_step(xc, blk, cfg: ModelConfig, lru_h, conv_st):
    """One token through a recurrent block (O(1) state): (out, h, conv
    window)."""
    xin = L.rms_norm(xc, blk["ln"], cfg.norm_eps)
    u = xin @ blk["w_x"]  # (b, 1, w)
    gate = F.gelu((xin @ blk["w_gate_in"]).float(), approximate="tanh")
    window = torch.cat([conv_st.to(xc.dtype), u], dim=1)  # (b, k, w)
    u1 = torch.einsum("bkc,kc->bc", window, blk["conv_w"]) + blk["conv_b"]
    uf = u1.float()
    r, i = _gates(uf, blk)
    log_a = -LRU_C * F.softplus(blk["a_param"].float()) * r
    h_new = torch.exp(log_a) * lru_h + torch.sqrt(
        torch.clamp_min(-torch.expm1(2.0 * log_a), 1e-12)) * (i * uf)
    y = (h_new[:, None] * gate).to(xc.dtype)
    return _mlp(xc + y @ blk["w_out"], blk, cfg), h_new, window[:, 1:].float()


def _att_step(xc, blk, cfg: ModelConfig, k_cache, v_cache, length, cos, sin):
    """One token through a local-attention block against its ring: the
    token's K/V written at ``length mod window``; every slot below
    ``min(length + 1, window)`` valid (RoPE is absolute, so the scores
    do not depend on the slots' order)."""
    b = xc.shape[0]
    cfg_l = _local(cfg)
    q, k, v = tr._qkv(L.rms_norm(xc, blk["ln1"], cfg.norm_eps), blk, cfg_l)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    window = k_cache.shape[1]
    slot = (length % window).view(1)
    k_cache = k_cache.index_copy(1, slot, k.to(k_cache.dtype))
    v_cache = v_cache.index_copy(1, slot, v.to(v_cache.dtype))
    out = L.decode_attention(q, k_cache, v_cache,
                             torch.clamp(length + 1, max=window))
    h = xc + out.reshape(b, 1, cfg.n_heads * cfg.hd) @ blk["wo"]
    ff, _ = tr.ffn_block(L.rms_norm(h, blk["ln2"], cfg.norm_eps), blk, cfg_l)
    return h + ff, k_cache, v_cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: HybridCache):
    """One decode step: ``tokens`` (b, 1) at position ``cache.length``
    → (logits (b, vocab) in ``cfg.dtype``, the next cache). The layers
    in the forward's order (each super-block's rec1, rec2, att, then the
    tail), the recurrent state indexed in that order. Runs on the device
    without reading the length back to the host. Under an installed
    ``tp`` rule set ``params`` and ``cache`` are this rank's blocks: each
    layer's cache blocks are gathered, the layer computed whole and this
    rank's blocks kept; the logits are its vocab columns where cut."""
    dtype = as_dtype(cfg.dtype)
    b = tokens.shape[0]
    tp = _tp_plan(cfg)
    x = _embed(params, cfg, tokens, tp)
    length = cache.length.long()
    cos, sin = L.rope_cos_sin(length.expand(b, 1), cfg.hd, cfg.rope_theta)

    n_super, n_tail, _ = split_layers(cfg.n_layers, cfg.hybrid_pattern)
    new_h, new_conv, new_k, new_v = [], [], [], []

    w = cfg.lru_width or cfg.d_model
    g = cfg.n_kv_heads

    def rec(x, blk):
        ri = len(new_h)
        h0, c0 = cache.lru_h[ri], cache.conv[ri]
        x, h1, c1 = _rec_step(x, blk, cfg, _joined(tp, h0, -1, w),
                              _joined(tp, c0, -1, w))
        new_h.append(_mine(tp, h1, -1, h0.shape[-1]))
        new_conv.append(_mine(tp, c1, -1, c0.shape[-1]))
        return x

    for si in range(n_super):
        sup = tr.cast_params(tree_map(lambda p: p[si], params["super"]),
                             dtype)
        x = rec(x, sup["rec1"])
        x = rec(x, sup["rec2"])
        held = cache.k.shape[3]
        x, k1, v1 = _att_step(x, sup["att"], cfg,
                              _joined(tp, cache.k[si], 2, g),
                              _joined(tp, cache.v[si], 2, g), length, cos, sin)
        new_k.append(_mine(tp, k1, 2, held))
        new_v.append(_mine(tp, v1, 2, held))
    for t in range(n_tail):
        x = rec(x, tr.cast_params(
            tree_map(lambda p: p[t], params["tail_rec"]), dtype))
    logits = _unembed(params, cfg, x, tp)
    return logits[:, 0], HybridCache(
        lru_h=torch.stack(new_h), conv=torch.stack(new_conv),
        k=torch.stack(new_k), v=torch.stack(new_v),
        length=cache.length + 1,
    )
