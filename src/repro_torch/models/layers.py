"""Shared model building blocks (port of ``repro.models.layers``): norms,
RoPE (incl. M-RoPE), GQA attention (full / sliding-window / chunked
streaming-softmax / KV-cache decode), the MLPs, the init helper and the
training loss.

Plain functions on tensors with the reference's dtype casts step for
step (f32 statistics, angles, logits and softmax; matmuls in the
inputs' dtype), so the numbers follow the reference's. The reference's
sharding annotations (``constrain``) become explicit collectives under
tensor parallelism: ``token_xent`` on logits cut by vocab over
``model`` and ``decode_attention`` on a cache cut by sequence reduce
their statistics over that axis (``distrib.sharding``'s
``ModelAxis``). Attention is the reference's materialised or streaming
form, not ``F.scaled_dot_product_attention``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distrib import comm
from repro_torch.distrib import sharding as shlib

f32 = torch.float32


# --- norms -------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-centred gain: statistics and scaling in
    float32, the result in ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with statistics in float32 (population variance), the
    result in ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


# --- rotary embeddings -------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, head_dim, 2) / head_dim)


def _angles(positions: torch.Tensor, head_dim: int, theta: float):
    inv = torch.as_tensor(rope_freqs(head_dim, theta), dtype=f32,
                          device=positions.device)
    return positions.float()[..., None] * inv


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., s) int → cos/sin (..., s, head_dim/2) f32."""
    ang = _angles(positions, head_dim, theta)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: tuple[int, int, int]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE: ``positions`` (3, b, s) carries the
    temporal/height/width position streams; the rotary frequency bands
    are split between them per ``sections`` (in dh/2 units)."""
    if sum(sections) != head_dim // 2:
        raise ValueError("mrope sections must sum to head_dim // 2")
    ang = _angles(positions, head_dim, theta)  # (3, b, s, dh/2)
    parts, start = [], 0
    for axis, width in enumerate(sections):
        parts.append(ang[axis, ..., start : start + width])
        start += width
    ang = torch.cat(parts, dim=-1)  # (b, s, dh/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (b, s, h, dh); cos/sin (b, s, dh/2) — rotate-half convention,
    in float32, the result in ``x``'s dtype."""
    dh = x.shape[-1]
    x1 = x[..., : dh // 2].float()
    x2 = x[..., dh // 2 :].float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --- attention ---------------------------------------------------------------


def expand_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: (b, t, g, dh) → (b, t, h, dh), each group repeated
    ``h / g`` times in place (``jnp.repeat``)."""
    g = kv.shape[2]
    if g == n_heads:
        return kv
    return torch.repeat_interleave(kv, n_heads // g, dim=2)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int | None) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softmax_scale: float | None = None) -> torch.Tensor:
    """Materialised GQA attention (short sequences): q (b, s, h, dh);
    k, v (b, t, g, dh) with g | h; queries right-aligned against the
    keys, masked logits at -1e30, the softmax in float32. The output
    (b, s, h, dh) in ``v``'s dtype."""
    b, s, h, dh = q.shape
    scale = softmax_scale or dh**-0.5
    kf = expand_kv(k, h)
    vf = expand_kv(v, h)
    logits = torch.einsum("bshd,bthd->bhst", (q * scale).float(), kf.float())
    t = k.shape[1]
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
    kpos = torch.arange(t, device=q.device)[None, :]
    logits = torch.where(_mask(qpos, kpos, causal, window)[None, None],
                         logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p.to(vf.dtype), vf)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      softmax_scale: float | None = None,
                      unroll: bool = False,
                      skip_masked_blocks: bool = False) -> torch.Tensor:
    """Streaming-softmax attention: O(s·c) live memory, a loop over KV
    chunks carrying the running (max, denom, acc) in float32.

    Every query chunk visits every KV chunk, masked as the reference's
    ``lax.scan`` does, unless ``unroll`` (the reference's static loop)
    with ``skip_masked_blocks`` drops the chunks wholly above the
    diagonal. For ``window == kv_chunk`` (causal) only the two chunks
    covering the window are visited: O(s·w), not O(s²); off ``unroll``
    a clipped duplicate (the first chunk twice) is visited twice, as in
    the reference, where the merge makes it a no-op on the output.
    """
    b, s, h, dh = q.shape
    t = k.shape[1]
    scale = softmax_scale or dh**-0.5
    if s % q_chunk or t % kv_chunk:
        raise ValueError(
            f"chunk sizes must divide seq: {s}/{q_chunk}, {t}/{kv_chunk}")
    nq, nk = s // q_chunk, t // kv_chunk
    qg = (q * scale).reshape(b, nq, q_chunk, h, dh)
    kc = expand_kv(k, h).reshape(b, nk, kv_chunk, h, dh)
    vc = expand_kv(v, h).reshape(b, nk, kv_chunk, h, dh)

    banded = window is not None and window == kv_chunk and causal
    if banded and kv_chunk % q_chunk != 0:
        raise ValueError("banded attention needs q_chunk | kv_chunk")

    q_ar = torch.arange(q_chunk, device=q.device)[:, None]
    k_ar = torch.arange(kv_chunk, device=q.device)[None, :]
    outs = []
    for iq in range(nq):
        q_blk = qg[:, iq].float()
        hi = ((iq + 1) * q_chunk - 1) // kv_chunk
        if banded:
            ids = [max(hi - 1, 0), hi]
            if unroll:
                ids = sorted(set(ids))
        elif unroll and causal and skip_masked_blocks:
            ids = list(range(hi + 1))
        else:
            ids = list(range(nk))
        m = torch.full((b, h, q_chunk), -torch.inf, dtype=f32,
                       device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=f32, device=q.device)
        acc = torch.zeros((b, h, q_chunk, dh), dtype=f32, device=q.device)
        for jk in ids:
            logits = torch.einsum("bshd,bthd->bhst", q_blk,
                                  kc[:, jk].float())
            mask = _mask(iq * q_chunk + q_ar, jk * kv_chunk + k_ar, causal,
                         window)
            logits = torch.where(mask[None, None], logits, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhst,bthd->bhsd", p, vc[:, jk].float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])  # (b,h,c,dh)
    out = torch.stack(outs, dim=2)  # (b, h, nq, c, dh)
    out = out.reshape(b, h, s, dh).transpose(1, 2)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int | None = None,
                     softmax_scale: float | None = None,
                     slots: torch.Tensor | None = None,
                     seq_axis: shlib.ModelAxis | None = None
                     ) -> torch.Tensor:
    """Single-token decode against a KV cache: q (b, 1, h, dh); caches
    (b, L, g, dh); ``cache_len`` (an int or a scalar tensor) the number
    of valid cache entries INCLUDING the current token.

    Under a cache cut by sequence over ``seq_axis`` the caches are this
    rank's slots, ``slots`` their global positions, and ``q`` holds
    every head: each rank scores its slots, the row max is taken over
    the axis first, then the exponentials' sums and the weighted values
    (float32) are summed over it and divided."""
    b, _, h, dh = q.shape
    scale = softmax_scale or dh**-0.5
    kf = expand_kv(k_cache, h)
    vf = expand_kv(v_cache, h)
    logits = torch.einsum("bshd,bthd->bhst", (q * scale).float(), kf.float())
    kpos = (torch.arange(k_cache.shape[1], device=q.device) if slots is None
            else slots)
    mask = kpos < cache_len
    if window is not None:
        mask &= kpos > cache_len - 1 - window
    logits = torch.where(mask[None, None, None], logits, -1e30)
    if seq_axis is None:
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhst,bthd->bshd", p.to(vf.dtype), vf)
    m = shlib.model_max(logits.amax(dim=-1, keepdim=True), seq_axis)
    p = torch.exp(logits - m)
    den = p.sum(dim=-1, keepdim=True)  # (b, h, 1, 1)
    acc = torch.einsum("bhst,bthd->bhsd", p, vf.float())
    sums = torch.cat([den, acc], dim=-1)
    comm.all_reduce_([sums], seq_axis.group)
    out = sums[..., 1:] / sums[..., :1]
    return out.transpose(1, 2).to(vf.dtype)


# --- MLPs --------------------------------------------------------------------


def gated_hidden(x, w_gate, w_up, kind: str = "swiglu"):
    """act(x·W_gate) ⊙ x·W_up, the activation in float32: ``swiglu``
    SiLU, ``geglu`` the tanh GELU."""
    gate = x @ w_gate
    up = x @ w_up
    if kind == "swiglu":
        act = F.silu(gate.float()).to(x.dtype)
    elif kind == "geglu":
        act = F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(kind)
    return act * up


def gated_mlp(x, w_gate, w_up, w_down, kind: str = "swiglu"):
    """(act(x·W_gate) ⊙ x·W_up)·W_down (:func:`gated_hidden`)."""
    return gated_hidden(x, w_gate, w_up, kind) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    h = F.gelu((x @ w_in + b_in).float(), approximate="tanh")
    return h.to(x.dtype) @ w_out + b_out


# --- init helpers ------------------------------------------------------------


def dense_init(
    generator: torch.Generator,
    shape: tuple[int, ...],
    scale: float | None = None,
) -> torch.Tensor:
    """Normal float32 init scaled by fan_in^-1/2, drawn from ``generator``
    on its device. For stacked layer params (L, d_in, d_out) the fan-in
    is the SECOND-TO-LAST dim, not the layer axis."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else max(fan_in, 1) ** -0.5
    return torch.randn(shape, generator=generator,
                       device=generator.device).mul_(scale)


class KVCache(NamedTuple):
    """Per-layer-stacked decode cache. Under tensor parallelism a rank
    holds its block (``launch.steps.cache_shardings``); where the block
    is cut by sequence, ``slots`` holds its slots' global positions
    (None: every slot)."""

    k: torch.Tensor  # (L, b, max_len, g, dh)
    v: torch.Tensor
    length: torch.Tensor  # () int32: valid entries
    slots: torch.Tensor | None = None  # (max_len / model,) int64


def token_xent(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    vocab_axis: shlib.ModelAxis | None = None,
) -> torch.Tensor:
    """Mean next-token cross-entropy over the positions ``mask`` keeps
    (all when None): logsumexp of the float32 logits minus the gold
    logit.

    With ``vocab_axis`` the logits are this rank's block of the vocab
    (block ``index`` of ``size`` over ``model``), as the reference's
    iota compare and masked sum keep them under GSPMD: the row max is
    taken over the axis, then the sums of exponentials and the gold
    logit (zero on the ranks that do not hold it) are summed over it, so
    the float32 logits and their gradient stay cut. Without it the gold
    logit is a ``gather`` of whole logits."""
    lf = logits.float()
    if vocab_axis is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    else:
        width = lf.shape[-1]
        m = shlib.model_max(lf.amax(dim=-1), vocab_axis)
        local = labels.long() - vocab_axis.index * width
        held = (local >= 0) & (local < width)
        mine = lf.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
        parts = torch.stack([torch.exp(lf - m[..., None]).sum(dim=-1),
                             torch.where(held, mine, 0.0)])
        total, gold = shlib.out_of_region(parts, vocab_axis).unbind(0)
        lse = m + torch.log(total)
    if mask is None:
        mask = torch.ones_like(lse)
    mask = mask.float()
    return ((lse - gold) * mask).sum() / mask.sum().clamp_min(1.0)
