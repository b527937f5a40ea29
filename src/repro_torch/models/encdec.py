"""Whisper-style encoder-decoder (whisper-small), port of
``repro.models.encdec``.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (b, encoder_seq, d). The transformer
backbone is whole: bidirectional encoder layers, causal decoder layers
with cross-attention, learned positional embeddings, pre-LN with
biased LayerNorms and a GELU MLP, the output projection tied to the
token embedding. Decoding is short-form (at most ``max_target_len``
tokens): :func:`init_decode_cache` takes the encoder's output and
computes every decoder layer's cross K/V once.

Every op is plain PyTorch: the reference computes this family in
``jnp`` outside any Pallas kernel. There is no remat, as there.

Tensor parallelism (the ``tp`` profile's ``model`` axis, installed by
``distrib.sharding.set_rules`` / ``rules_context``): the reference's
``PARAM_RULES`` cut ``enc_blocks/w_in`` and ``blocks/w_in`` by columns
and their ``w_out`` by rows, and ``embed`` by vocab where the vocab
divides the axis (whole at full whisper's odd 51865); every attention
leaf, ``b_in`` and ``b_out`` stay whole. Each rank holds those blocks
and computes Megatron-style: the MLP on its ``w_in`` columns (with its
slice of the whole ``b_in``) and ``w_out``'s rows, summed over ``model``
in float32, ``b_out`` added once after the sum; the self- and
cross-attention on its heads, from the whole leaves sliced locally (so
their gradients are summed over ``model``), ``wo``'s rows of those
heads summed likewise and ``bo`` added once, which matches the decode
cache's cut by heads (``cache_shardings``). A vocab-cut embedding is
looked up vocab-parallel and the tied logits are this rank's vocab
columns. Where the heads (or the MLP's hidden width) do not split, that
part runs whole on every rank.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

import torch.nn.functional as F

from repro_torch import as_dtype, resolve_device
from repro_torch.distrib import sharding as shlib
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    cast_params,
    embed_tokens,
    scan_layers,
    tp_logits,
)
from repro_torch.tree import path_str, tree_leaves_with_path

Params = dict[str, Any]
f32 = torch.float32


class EncDecCache(NamedTuple):
    k: torch.Tensor  # (L, b, max_target, h, dh) decoder self-attention
    v: torch.Tensor
    xk: torch.Tensor  # (L, b, enc_seq, h, dh) cross K/V, computed once
    xv: torch.Tensor
    length: torch.Tensor  # () int32


# --- init ----------------------------------------------------------------------


def _attn_shapes(n: int, d: int, h: int, hd: int) -> dict[str, tuple]:
    return {
        "wq": (n, d, h * hd), "wk": (n, d, h * hd), "wv": (n, d, h * hd),
        "wo": (n, h * hd, d),
        "bq": (n, h * hd), "bv": (n, h * hd), "bo": (n, d),
    }


def _block_shapes(n: int, d: int, h: int, hd: int, ff: int, cross: bool
                  ) -> dict[str, Any]:
    shapes: dict[str, Any] = {
        "ln1_w": (n, d), "ln1_b": (n, d),
        "attn": _attn_shapes(n, d, h, hd),
        "ln2_w": (n, d), "ln2_b": (n, d),
        "w_in": (n, d, ff), "b_in": (n, ff),
        "w_out": (n, ff, d), "b_out": (n, d),
    }
    if cross:
        shapes.update(lnx_w=(n, d), lnx_b=(n, d),
                      xattn=_attn_shapes(n, d, h, hd))
    return shapes


def _shapes(cfg: ModelConfig) -> dict[str, Any]:
    d, h, hd, ff = cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff
    return {
        "enc_pos": (cfg.encoder_seq, d),
        "enc_blocks": _block_shapes(cfg.n_encoder_layers, d, h, hd, ff,
                                    False),
        "enc_ln_w": (d,), "enc_ln_b": (d,),
        "embed": (cfg.vocab, d),
        "dec_pos": (cfg.max_target_len, d),
        "blocks": _block_shapes(cfg.n_layers, d, h, hd, ff, True),
        "dec_ln_w": (d,), "dec_ln_b": (d,),
    }


# The leaves drawn by ``dense_init``, and the scale of those not drawn at
# fan-in^-1/2; the LayerNorm gains are ones, every other leaf zeros.
_DRAWN = ("wq", "wk", "wv", "wo", "w_in", "w_out", "enc_pos", "embed",
          "dec_pos")
_SCALE = {"enc_pos": 0.02, "embed": 0.02, "dec_pos": 0.02}


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> Params:
    """Random init (the reference's tree, shapes and scales: positional
    and token embeddings at 0.02, projections at fan-in^-1/2, LayerNorm
    gains 1, biases 0) from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card by default; it raises without one unless
    ``device="cpu"``). The draws differ from ``jax.random``'s: to compare
    with the reference, carry its parameters across with
    ``convert.model_params_from_numpy``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(name, shapes):
        if isinstance(shapes, dict):
            return {k: make(k, s) for k, s in shapes.items()}
        if name in _DRAWN:
            return L.dense_init(gen, shapes, scale=_SCALE.get(name))
        if name.endswith("_w"):
            return torch.ones(shapes, device=dev)
        return torch.zeros(shapes, device=dev)

    return make("", _shapes(cfg))


def abstract_params(cfg: ModelConfig) -> Params:
    """The tree :func:`init_params` makes, as float32 tensors on the
    ``meta`` device (shapes, no storage): the reference's
    ``launch.specs.abstract_params``, which the sharding rules read."""

    def meta(shapes):
        if isinstance(shapes, dict):
            return {k: meta(s) for k, s in shapes.items()}
        return torch.empty(shapes, dtype=f32, device="meta")

    return meta(_shapes(cfg))


# --- tensor parallelism --------------------------------------------------------

_ATTN = ("wq", "wk", "wv", "bq", "bv", "wo")


class _TP(NamedTuple):
    """This rank's part of whisper on the installed mesh's ``model``
    axis: ``held[path]`` is ``sharding.leaf_held``'s (how, per-layer
    dim) of every leaf, ``heads`` this rank's heads [lo, hi) where they
    split over the ranks (None: attention whole on every rank)."""

    axis: shlib.ModelAxis
    held: dict
    heads: tuple[int, int] | None

    def cut(self, path: str) -> bool:
        return self.held[path][0] != "whole"


def _tp_plan(cfg: ModelConfig) -> _TP | None:
    """None without a ``tp`` rule set on a ``model`` axis above one
    rank."""
    axis = shlib.model_axis()
    if axis is None:
        return None
    plans = axis.mesh.__dict__.setdefault("_tp_plans", {})
    if cfg not in plans:
        held = {}
        for path, leaf in tree_leaves_with_path(abstract_params(cfg)):
            path = path_str(path)
            unit = cfg.hd if path.rsplit("/", 1)[-1] in _ATTN else 1
            how, dim = shlib.leaf_held(path, tuple(leaf.shape), unit)
            stacked = path.split("/")[0] in ("enc_blocks", "blocks")
            held[path] = (how, dim - 1 if stacked and dim is not None
                          else dim)
        h, m, r = cfg.n_heads, axis.size, axis.index
        heads = (r * h // m, (r + 1) * h // m) if h % m == 0 else None
        plans[cfg] = _TP(axis, held, heads)
    return plans[cfg]


def _attn_region(p: Params, tp: _TP, path: str, hd: int) -> Params:
    """The attention leaves at ``path`` (e.g. ``blocks/xattn``) on this
    rank's heads inside a region: the columns of ``wq``, ``wk``, ``wv``,
    ``bq``, ``bv`` and the rows of ``wo`` (``sharding.region_slice``),
    ``bo`` as it is."""
    lo, hi = tp.heads
    out = {"bo": p["bo"]}
    for k in _ATTN:
        how, dim = tp.held[f"{path}/{k}"]
        out[k] = shlib.region_slice(
            p[k], tp.axis, how, (0 if k == "wo" else -1) if dim is None
            else dim, lo * hd, (hi - lo) * hd)
    return out


# --- the layers ----------------------------------------------------------------


def _heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], -1, cfg.hd)


def _mha(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
         kv: torch.Tensor | None = None, causal: bool,
         tp: _TP | None = None, path: str = "") -> torch.Tensor:
    """Whisper's multi-head attention (no k bias, as the original): on
    ``x`` itself, or across to ``kv``; materialised up to 2048 queries,
    the streaming form above. Under ``tp`` with split heads, this
    rank's heads of the leaves at ``path``, ``wo``'s rows summed over
    ``model`` and ``bo`` added once."""
    b, s, _ = x.shape
    region = tp is not None and tp.heads is not None
    if region:
        x = shlib.into_region(x, tp.axis)
        kv = None if kv is None else shlib.into_region(kv, tp.axis)
        p = _attn_region(p, tp, path, cfg.hd)
    src = x if kv is None else kv
    q = _heads(x @ p["wq"] + p["bq"], cfg)
    k = _heads(src @ p["wk"], cfg)
    v = _heads(src @ p["wv"] + p["bv"], cfg)
    if s > 2048:
        out = L.chunked_attention(q, k, v, causal=causal)
    else:
        out = L.attention(q, k, v, causal=causal)
    out = out.reshape(b, s, -1)
    if region:
        return shlib.row_parallel(out, p["wo"], tp.axis) + p["bo"]
    return out @ p["wo"] + p["bo"]


def _mlp(h: torch.Tensor, blk: Params, tp: _TP | None = None,
         path: str = "") -> torch.Tensor:
    """The residual GELU MLP. Under ``tp`` where ``w_in`` is cut, this
    rank's hidden columns (its slice of the whole ``b_in``), ``w_out``'s
    rows summed over ``model`` and ``b_out`` added once."""
    x = L.layer_norm(h, blk["ln2_w"], blk["ln2_b"])
    if tp is None or not tp.cut(f"{path}/w_in"):
        return h + L.gelu_mlp(x, blk["w_in"], blk["b_in"], blk["w_out"],
                              blk["b_out"])
    x = shlib.into_region(x, tp.axis)
    width = blk["w_in"].shape[-1]
    b_in = shlib.region_slice(blk["b_in"], tp.axis, tp.held[f"{path}/b_in"][0],
                              -1, tp.axis.index * width, width)
    hid = F.gelu((x @ blk["w_in"] + b_in).float(), approximate="tanh")
    return h + shlib.row_parallel(hid.to(x.dtype), blk["w_out"], tp.axis) \
        + blk["b_out"]


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """``frames`` (b, encoder_seq, d), the stubbed frontend's output →
    the encoder's output (b, encoder_seq, d) in ``cfg.dtype``, whole on
    every rank under ``tp``."""
    dtype = as_dtype(cfg.dtype)
    tp = _tp_plan(cfg)
    x = frames.to(dtype) + params["enc_pos"].to(dtype)

    def body(carry, blk):
        blk = cast_params(blk, dtype)
        h = carry + _mha(L.layer_norm(carry, blk["ln1_w"], blk["ln1_b"]),
                         blk["attn"], cfg, causal=False, tp=tp,
                         path="enc_blocks/attn")
        return _mlp(h, blk, tp, "enc_blocks"), 0.0

    x, _ = scan_layers(body, x, params["enc_blocks"])
    return L.layer_norm(x, params["enc_ln_w"], params["enc_ln_b"])


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           tp: _TP | None) -> torch.Tensor:
    axis = tp.axis if tp is not None and tp.cut("embed") else None
    return embed_tokens(params["embed"], tokens, as_dtype(cfg.dtype), axis)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
            tp: _TP | None = None):
    """The decoder's final LayerNorm, then the tied projection: this
    rank's vocab columns where ``tp`` cuts ``embed``."""
    x = L.layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
    w = params["embed"].T.to(x.dtype)
    if tp is None or not tp.cut("embed"):
        return x @ w
    return tp_logits(x, w, tp.axis, rows=False)


def decode_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder over ``tokens`` (b, s) against
    ``enc_out`` → logits (b, s, vocab) in ``cfg.dtype`` (this rank's
    vocab columns where ``tp`` cuts ``embed``)."""
    dtype = as_dtype(cfg.dtype)
    s = tokens.shape[1]
    tp = _tp_plan(cfg)
    x = _embed(params, cfg, tokens, tp) + params["dec_pos"][:s].to(dtype)

    def body(carry, blk):
        blk = cast_params(blk, dtype)
        h = carry + _mha(L.layer_norm(carry, blk["ln1_w"], blk["ln1_b"]),
                         blk["attn"], cfg, causal=True, tp=tp,
                         path="blocks/attn")
        h = h + _mha(L.layer_norm(h, blk["lnx_w"], blk["lnx_b"]),
                     blk["xattn"], cfg, kv=enc_out, causal=False, tp=tp,
                     path="blocks/xattn")
        return _mlp(h, blk, tp, "blocks"), 0.0

    x, _ = scan_layers(body, x, params["blocks"])
    return _logits(params, cfg, x, tp)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frames: torch.Tensor):
    """(logits (b, s, vocab) in ``cfg.dtype``, a zero aux loss): the
    encoder on ``frames``, then the decoder on ``tokens``. Under an
    installed ``tp`` rule set ``params`` are this rank's blocks and the
    logits its vocab columns where ``embed`` is cut."""
    logits = decode_train(params, cfg, tokens, encode(params, cfg, frames))
    return logits, torch.zeros((), dtype=f32, device=logits.device)


def lm_loss(params: Params, cfg: ModelConfig, batch: dict):
    """(next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` under the optional ``loss_mask``, given
    ``batch["frames"]``; {"xent"}); vocab-parallel where the logits are
    cut."""
    logits, _ = forward(params, cfg, batch["tokens"], frames=batch["frames"])
    cut = logits.shape[-1] < cfg.vocab
    loss = L.token_xent(logits, batch["labels"], batch.get("loss_mask"),
                        vocab_axis=_tp_plan(cfg).axis if cut else None)
    return loss, {"xent": loss}


# --- decode (short-form serving) --------------------------------------------


def init_decode_cache(params: Params, cfg: ModelConfig,
                      enc_out: torch.Tensor) -> EncDecCache:
    """An empty self-attention cache of ``max_target_len`` slots and each
    decoder layer's cross K/V of ``enc_out`` (b, encoder_seq, d), in
    ``cfg.dtype`` on ``enc_out``'s device. Under an installed ``tp``
    rule set where the heads split, this rank's heads of both (the
    reference's ``cache_shardings`` block; ``params`` this rank's
    blocks, ``enc_out`` its rows' whole encoder output)."""
    dtype = as_dtype(cfg.dtype)
    b = enc_out.shape[0]
    enc = enc_out.to(dtype)
    tp = _tp_plan(cfg)
    heads = (0, cfg.n_heads) if tp is None or tp.heads is None else tp.heads
    cols = slice(heads[0] * cfg.hd, heads[1] * cfg.hd)
    xattn = params["blocks"]["xattn"]
    xk, xv = [], []
    for wk, wv, bv in zip(xattn["wk"].to(dtype), xattn["wv"].to(dtype),
                          xattn["bv"].to(dtype)):
        xk.append(_heads(enc @ wk[:, cols], cfg))
        xv.append(_heads(enc @ wv[:, cols] + bv[cols], cfg))
    shape = (cfg.n_layers, b, cfg.max_target_len, heads[1] - heads[0],
             cfg.hd)
    dev = enc_out.device
    return EncDecCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        xk=torch.stack(xk), xv=torch.stack(xv),
        length=torch.zeros((), dtype=torch.int32, device=dev),
    )


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: EncDecCache):
    """One decode step: ``tokens`` (b, 1) at position ``cache.length``
    (its ``dec_pos`` row; the slot held to the last when the cache is
    full, as the reference's ``dynamic_slice`` and
    ``dynamic_update_slice`` clamp), self-attention over the cache, then
    cross-attention over every encoder frame → (logits (b, vocab) in
    ``cfg.dtype``, the next cache). Runs on the device without reading
    the length back to the host. Under an installed ``tp`` rule set
    ``params`` and ``cache`` are this rank's blocks: both attentions run
    on its heads, the logits are its vocab columns where cut."""
    dtype = as_dtype(cfg.dtype)
    b = tokens.shape[0]
    tp = _tp_plan(cfg)
    region = tp is not None and tp.heads is not None
    length = cache.length.long()
    slot = length.clamp(max=cache.k.shape[2] - 1).view(1)
    x = _embed(params, cfg, tokens, tp) \
        + params["dec_pos"].index_select(0, slot).to(dtype)

    def attend(xin, p, path):
        if region:
            return (shlib.into_region(xin, tp.axis),
                    _attn_region(p, tp, path, cfg.hd))
        return xin, p

    def out_proj(out, p):
        out = out.reshape(b, 1, -1)
        if region:
            return shlib.row_parallel(out, p["wo"], tp.axis) + p["bo"]
        return out @ p["wo"] + p["bo"]

    def body(carry, scanned):
        (xc,) = carry
        blk, kc, vc, xk, xv = scanned
        blk = cast_params(blk, dtype)
        xin, ap = attend(L.layer_norm(xc, blk["ln1_w"], blk["ln1_b"]),
                         blk["attn"], "blocks/attn")
        q = _heads(xin @ ap["wq"] + ap["bq"], cfg)
        kc = kc.index_copy(1, slot, _heads(xin @ ap["wk"], cfg).to(kc.dtype))
        vc = vc.index_copy(1, slot, _heads(xin @ ap["wv"] + ap["bv"],
                                           cfg).to(vc.dtype))
        h = xc + out_proj(L.decode_attention(q, kc, vc, length + 1), ap)
        xin2, xp = attend(L.layer_norm(h, blk["lnx_w"], blk["lnx_b"]),
                          blk["xattn"], "blocks/xattn")
        q2 = _heads(xin2 @ xp["wq"] + xp["bq"], cfg)
        h = h + out_proj(L.decode_attention(q2, xk, xv, xk.shape[1]), xp)
        return (_mlp(h, blk, tp, "blocks"),), (kc, vc)

    (x,), (k_new, v_new) = scan_layers(
        body, (x,), (params["blocks"], cache.k, cache.v, cache.xk, cache.xv))
    return _logits(params, cfg, x, tp)[:, 0], EncDecCache(
        k_new, v_new, cache.xk, cache.xv, cache.length + 1)
