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
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import as_dtype, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import cast_params, scan_layers

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


# --- the layers ----------------------------------------------------------------


def _heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], cfg.n_heads, cfg.hd)


def _mha(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
         kv: torch.Tensor | None = None, causal: bool) -> torch.Tensor:
    """Whisper's multi-head attention (no k bias, as the original): on
    ``x`` itself, or across to ``kv``; materialised up to 2048 queries,
    the streaming form above."""
    b, s, _ = x.shape
    src = x if kv is None else kv
    q = _heads(x @ p["wq"] + p["bq"], cfg)
    k = _heads(src @ p["wk"], cfg)
    v = _heads(src @ p["wv"] + p["bv"], cfg)
    if s > 2048:
        out = L.chunked_attention(q, k, v, causal=causal)
    else:
        out = L.attention(q, k, v, causal=causal)
    return out.reshape(b, s, -1) @ p["wo"] + p["bo"]


def _mlp(h: torch.Tensor, blk: Params) -> torch.Tensor:
    return h + L.gelu_mlp(L.layer_norm(h, blk["ln2_w"], blk["ln2_b"]),
                          blk["w_in"], blk["b_in"], blk["w_out"],
                          blk["b_out"])


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """``frames`` (b, encoder_seq, d), the stubbed frontend's output →
    the encoder's output (b, encoder_seq, d) in ``cfg.dtype``."""
    dtype = as_dtype(cfg.dtype)
    x = frames.to(dtype) + params["enc_pos"].to(dtype)

    def body(carry, blk):
        blk = cast_params(blk, dtype)
        h = carry + _mha(L.layer_norm(carry, blk["ln1_w"], blk["ln1_b"]),
                         blk["attn"], cfg, causal=False)
        return _mlp(h, blk), 0.0

    x, _ = scan_layers(body, x, params["enc_blocks"])
    return L.layer_norm(x, params["enc_ln_w"], params["enc_ln_b"])


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor):
    """The decoder's final LayerNorm, then the tied projection."""
    x = L.layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
    return x @ params["embed"].T.to(x.dtype)


def decode_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder over ``tokens`` (b, s) against
    ``enc_out`` → logits (b, s, vocab) in ``cfg.dtype``."""
    dtype = as_dtype(cfg.dtype)
    s = tokens.shape[1]
    x = params["embed"][tokens].to(dtype) + params["dec_pos"][:s].to(dtype)

    def body(carry, blk):
        blk = cast_params(blk, dtype)
        h = carry + _mha(L.layer_norm(carry, blk["ln1_w"], blk["ln1_b"]),
                         blk["attn"], cfg, causal=True)
        h = h + _mha(L.layer_norm(h, blk["lnx_w"], blk["lnx_b"]),
                     blk["xattn"], cfg, kv=enc_out, causal=False)
        return _mlp(h, blk), 0.0

    x, _ = scan_layers(body, x, params["blocks"])
    return _logits(params, cfg, x)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frames: torch.Tensor):
    """(logits (b, s, vocab) in ``cfg.dtype``, a zero aux loss): the
    encoder on ``frames``, then the decoder on ``tokens``."""
    logits = decode_train(params, cfg, tokens, encode(params, cfg, frames))
    return logits, torch.zeros((), dtype=f32, device=logits.device)


def lm_loss(params: Params, cfg: ModelConfig, batch: dict):
    """(next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` under the optional ``loss_mask``, given
    ``batch["frames"]``; {"xent"})."""
    logits, _ = forward(params, cfg, batch["tokens"], frames=batch["frames"])
    loss = L.token_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"xent": loss}


# --- decode (short-form serving) --------------------------------------------


def init_decode_cache(params: Params, cfg: ModelConfig,
                      enc_out: torch.Tensor) -> EncDecCache:
    """An empty self-attention cache of ``max_target_len`` slots and each
    decoder layer's cross K/V of ``enc_out`` (b, encoder_seq, d), in
    ``cfg.dtype`` on ``enc_out``'s device."""
    dtype = as_dtype(cfg.dtype)
    b = enc_out.shape[0]
    enc = enc_out.to(dtype)
    xattn = params["blocks"]["xattn"]
    xk, xv = [], []
    for wk, wv, bv in zip(xattn["wk"].to(dtype), xattn["wv"].to(dtype),
                          xattn["bv"].to(dtype)):
        xk.append(_heads(enc @ wk, cfg))
        xv.append(_heads(enc @ wv + bv, cfg))
    shape = (cfg.n_layers, b, cfg.max_target_len, cfg.n_heads, cfg.hd)
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
    the length back to the host."""
    dtype = as_dtype(cfg.dtype)
    b = tokens.shape[0]
    length = cache.length.long()
    slot = length.clamp(max=cache.k.shape[2] - 1).view(1)
    x = params["embed"][tokens].to(dtype) \
        + params["dec_pos"].index_select(0, slot).to(dtype)

    def body(carry, scanned):
        (xc,) = carry
        blk, kc, vc, xk, xv = scanned
        blk = cast_params(blk, dtype)
        ap = blk["attn"]
        xin = L.layer_norm(xc, blk["ln1_w"], blk["ln1_b"])
        q = _heads(xin @ ap["wq"] + ap["bq"], cfg)
        kc = kc.index_copy(1, slot, _heads(xin @ ap["wk"], cfg).to(kc.dtype))
        vc = vc.index_copy(1, slot, _heads(xin @ ap["wv"] + ap["bv"],
                                           cfg).to(vc.dtype))
        out = L.decode_attention(q, kc, vc, length + 1)
        h = xc + out.reshape(b, 1, -1) @ ap["wo"] + ap["bo"]
        xp = blk["xattn"]
        xin2 = L.layer_norm(h, blk["lnx_w"], blk["lnx_b"])
        q2 = _heads(xin2 @ xp["wq"] + xp["bq"], cfg)
        out2 = L.decode_attention(q2, xk, xv, xk.shape[1])
        h = h + out2.reshape(b, 1, -1) @ xp["wo"] + xp["bo"]
        return (_mlp(h, blk),), (kc, vc)

    (x,), (k_new, v_new) = scan_layers(
        body, (x,), (params["blocks"], cache.k, cache.v, cache.xk, cache.xv))
    return _logits(params, cfg, x)[:, 0], EncDecCache(
        k_new, v_new, cache.xk, cache.xv, cache.length + 1)
