"""Mamba-2 (SSD — state-space duality) family (mamba2-780m), port of
``repro.models.ssm``.

The block follows arXiv:2405.21060: in_proj → depthwise causal conv (the
paper-technique stencil; on the card the B7 kernel
``csrc/conv1d_depthwise.cu``) → SSD sequence mixing in the chunked dual
form (intra-chunk quadratic attention-like matmuls + inter-chunk linear
recurrence) → gated RMSNorm → out_proj.

Both the chunked-parallel form (prefill) and the O(1)-state recurrent
form (decode) are here, with the reference's casts: the compute dtype
for matmul weights and activations, float32 for the norms, gates, the
SSD sums and the decode cache. Parameters are nested dicts of tensors,
blocks stacked along a leading layer axis, as in the reference; the
reference's sharding constraints have no counterpart on one card.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import as_dtype, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import cast_params, scan_layers

Params = dict[str, Any]
f32 = torch.float32


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (n_layers, b, k-1, conv_ch) f32
    state: torch.Tensor  # (n_layers, b, h, n, p) f32
    length: torch.Tensor  # () int32


def _dims(cfg: ModelConfig):
    dv = cfg.d_inner
    h = cfg.ssm_n_heads
    p = cfg.ssm_head_dim
    g = cfg.ssm_n_groups
    n = cfg.ssm_state
    conv_ch = dv + 2 * g * n
    return dv, h, p, g, n, conv_ch


def init_block_params(cfg: ModelConfig, gen: torch.Generator,
                      n_layers: int) -> Params:
    d = cfg.d_model
    dv, h, p, g, n, conv_ch = _dims(cfg)
    in_dim = 2 * dv + 2 * g * n + h  # z, xBC, dt
    dev = gen.device

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    return {
        "ln1": zeros(n_layers, d),
        "in_proj": L.dense_init(gen, (n_layers, d, in_dim)),
        "conv_w": L.dense_init(gen, (n_layers, cfg.ssm_conv_kernel, conv_ch)),
        "conv_b": zeros(n_layers, conv_ch),
        "A_log": zeros(n_layers, h),  # A = -exp(A_log) = -1
        "D": torch.ones((n_layers, h), device=dev),
        "dt_bias": zeros(n_layers, h),
        "ssm_norm": zeros(n_layers, dv),
        "out_proj": L.dense_init(gen, (n_layers, dv, d)),
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> Params:
    """Random init (the reference's shapes and scales) from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card by
    default; it raises without one unless ``device="cpu"``). The draws
    differ from ``jax.random``'s: to compare with the reference, carry
    its parameters across with ``convert.ssm_params_from_numpy``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model),
                              scale=cfg.d_model**-0.5),
        "blocks": init_block_params(cfg, gen, cfg.n_layers),
        "final_norm": torch.zeros((cfg.d_model,), device=dev),
        "unembed": L.dense_init(gen, (cfg.d_model, cfg.vocab)),
    }


# --- SSD core ---------------------------------------------------------------


def _repeat_heads(t: torch.Tensor, hg: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, hg, axis=dim)``: each group's slice ``hg`` times."""
    return t if hg == 1 else torch.repeat_interleave(t, hg, dim=dim)


def ssd_chunked(
    x: torch.Tensor,  # (b, l, h, p) — dt-scaled inputs
    dA: torch.Tensor,  # (b, l, h)   — log decay per step (≤ 0)
    B: torch.Tensor,  # (b, l, g, n)
    C: torch.Tensor,  # (b, l, g, n)
    chunk: int,
    initial_state: torch.Tensor | None = None,  # (b, h, n, p)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD dual form → (y (b, l, h, p) f32, final state
    (b, h, n, p) f32).

    Within a chunk: a masked quadratic form (batched matmuls). Across
    chunks: the linear recurrence over per-chunk states, a loop over the
    chunks (the reference's ``lax.scan``).
    """
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    nc = l // chunk

    xc = x.reshape(b, nc, chunk, h, p).float()
    dAc = dA.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n).float()
    Cc = C.reshape(b, nc, chunk, g, n).float()

    A_cs = torch.cumsum(dAc, dim=2)  # inclusive within-chunk cumsum
    A_end = A_cs[:, :, -1]  # (b, nc, h)

    # Intra-chunk: y_i += Σ_{j≤i} C_i·B_j · exp(A_cs_i − A_cs_j) · x_j
    CB = torch.einsum("bkigN,bkjgN->bkgij", Cc, Bc)  # (b, nc, g, c, c)
    # (b, nc, h, c), contiguous so that the (b, nc, h, i, j) decay is laid
    # out as the batched matmul below reads it (no 4-byte-strided copy).
    At = A_cs.permute(0, 1, 3, 2).contiguous()
    decay = (At[..., :, None] - At[..., None, :]).exp_()
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    decay = decay.masked_fill_(~causal, 0.0)
    # Each head times its group's C·B (the reference repeats CB per head).
    M = (decay.view(b, nc, g, hg, chunk, chunk)
         * CB[:, :, :, None]).view(b, nc, h, chunk, chunk)
    del decay, CB
    y_intra = torch.einsum("bkhij,bkjhp->bkihp", M, xc)
    del M

    # Per-chunk end states: S_k = Σ_j exp(A_end − A_cs_j) B_j x_j^T
    dec_state = torch.exp(A_end[:, :, None, :] - A_cs)  # (b, nc, c, h)
    Bh = _repeat_heads(Bc, hg, 3).reshape(b, nc, chunk, h, n)
    S = torch.einsum("bkchn,bkchp->bkhnp", Bh * dec_state[..., None], xc)

    # Inter-chunk recurrence: S_run_k = exp(A_end_k)·S_run_{k-1} + S_k,
    # keeping the state ENTERING each chunk.
    s_run = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
             if initial_state is None else initial_state.float())
    a_end = torch.exp(A_end)  # (b, nc, h)
    entering = []
    for k in range(nc):
        entering.append(s_run)
        s_run = a_end[:, k, :, None, None] * s_run + S[:, k]
    S_prev = torch.stack(entering, dim=1)  # (b, nc, h, n, p)

    # Inter-chunk contribution: y_i += C_i · exp(A_cs_i) · S_prev
    Ch = _repeat_heads(Cc, hg, 3).reshape(b, nc, chunk, h, n)
    y_inter = torch.einsum("bkchn,bkhnp->bkchp",
                           Ch * torch.exp(A_cs)[..., None], S_prev)
    y = (y_intra + y_inter).reshape(b, l, h, p)
    return y, s_run


def ssd_sequential(x, dA, B, C, initial_state=None):
    """Step-by-step oracle for :func:`ssd_chunked` (tests)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    Bh = _repeat_heads(B, hg, 2).float()
    Ch = _repeat_heads(C, hg, 2).float()
    state = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(l):
        a = torch.exp(dA[:, t].float())  # (b, h)
        upd = Bh[:, t, :, :, None] * x[:, t, :, None, :].float()
        state = a[:, :, None, None] * state + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1), state


# --- block -------------------------------------------------------------------


def _split_in_proj(proj, cfg: ModelConfig):
    dv, h, p, g, n, conv_ch = _dims(cfg)
    z = proj[..., :dv]
    xBC = proj[..., dv : dv + conv_ch]
    dt = proj[..., dv + conv_ch :]
    return z, xBC, dt


def ssm_block(x: torch.Tensor, blk: Params, cfg: ModelConfig,
              use_pallas_conv: bool) -> torch.Tensor:
    """Full mamba2 mixer over (b, l, d). ``use_pallas_conv`` keeps the
    reference's switch: True goes through ``ops.conv1d_depthwise`` (the
    B7 kernel on a CUDA tensor, its plain version on a CPU one), False
    through the plain ``ref.conv1d_depthwise_causal``. Either way the
    conv is called without its activation; the bias is added in
    ``x.dtype`` and SiLU applied in float32 after it, as in the
    reference."""
    b, l, d = x.shape
    dv, h, p, g, n, conv_ch = _dims(cfg)
    proj = x @ blk["in_proj"]
    z, xBC, dt = _split_in_proj(proj, cfg)
    conv_w = blk["conv_w"].to(x.dtype)
    if use_pallas_conv:
        xBC = kops.conv1d_depthwise(xBC, conv_w, activation="none")
    else:
        xBC = kref.conv1d_depthwise_causal(xBC, conv_w)
    xBC = xBC + blk["conv_b"].to(x.dtype)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs = xBC[..., :dv].reshape(b, l, h, p)
    B = xBC[..., dv : dv + g * n].reshape(b, l, g, n)
    C = xBC[..., dv + g * n :].reshape(b, l, g, n)
    dt = F.softplus(dt.float() + blk["dt_bias"].float())  # (b, l, h)
    A = -torch.exp(blk["A_log"].float())  # (h,)
    dA = dt * A  # (b, l, h)
    x_in = (xs.float() * dt[..., None]).to(x.dtype)
    y, _ = ssd_chunked(x_in, dA, B, C, min(cfg.ssm_chunk, l))
    y = y + blk["D"].float()[None, None, :, None] * xs.float()
    y = y.reshape(b, l, dv)
    gated = y * F.silu(z.float())
    y = L.rms_norm(gated.to(x.dtype), blk["ssm_norm"], cfg.norm_eps)
    return y @ blk["out_proj"]


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            use_pallas_conv: bool | None = None):
    """Logits (b, s, vocab) in ``cfg.dtype`` and a zero aux loss.

    ``use_pallas_conv=None`` takes the B7 kernel when the tokens lie on
    the card and the plain conv on the CPU (the reference decides by
    backend, ``jax.default_backend() == "tpu"``).
    """
    dtype = as_dtype(cfg.dtype)
    if use_pallas_conv is None:
        use_pallas_conv = tokens.device.type == "cuda"
    x = params["embed"][tokens].to(dtype)

    def body(xc, blk):
        blk = cast_params(blk, dtype)
        out = xc + ssm_block(L.rms_norm(xc, blk["ln1"], cfg.norm_eps), blk,
                             cfg, use_pallas_conv)
        return out, 0.0

    x, _ = scan_layers(body, x, params["blocks"])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["unembed"].to(dtype)
    return logits, torch.zeros((), dtype=f32, device=logits.device)


# --- decode ------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device | None = None) -> SSMCache:
    """An empty decode cache on ``device`` (the card by default)."""
    del max_len  # O(1) state — the whole point of the SSM family
    dev = resolve_device(device)
    dv, h, p, g, n, conv_ch = _dims(cfg)
    return SSMCache(
        conv=torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_conv_kernel - 1, conv_ch),
            dtype=f32, device=dev,
        ),
        state=torch.zeros((cfg.n_layers, batch, h, n, p), dtype=f32,
                          device=dev),
        length=torch.zeros((), dtype=torch.int32, device=dev),
    )


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: SSMCache):
    """One recurrent decode step — O(1) in context length. ``tokens``
    (b, 1) → logits (b, vocab) in ``cfg.dtype`` and the next cache."""
    dtype = as_dtype(cfg.dtype)
    b = tokens.shape[0]
    dv, h, p, g, n, conv_ch = _dims(cfg)
    hg = h // g
    x = params["embed"][tokens].to(dtype)  # (b, 1, d)

    def body(carry, scanned):
        (xc,) = carry
        blk, conv_st, ssm_st = scanned
        blk = cast_params(blk, dtype)
        xin = L.rms_norm(xc, blk["ln1"], cfg.norm_eps)
        proj = xin @ blk["in_proj"]
        z, xBC, dt = _split_in_proj(proj, cfg)
        # conv over the (k-1) carried inputs + current
        window = torch.cat([conv_st.to(xc.dtype), xBC], dim=1)  # (b, k, ch)
        conv = torch.einsum("bkc,kc->bc", window, blk["conv_w"]) \
            + blk["conv_b"]
        conv = F.silu(conv.float()).to(xc.dtype)
        new_conv_st = window[:, 1:].float()
        xs = conv[..., :dv].reshape(b, h, p)
        B = conv[..., dv : dv + g * n].reshape(b, g, n)
        C = conv[..., dv + g * n :].reshape(b, g, n)
        dtv = F.softplus(dt[:, 0].float() + blk["dt_bias"].float())  # (b, h)
        A = -torch.exp(blk["A_log"].float())
        a = torch.exp(dtv * A)  # (b, h)
        Bh = _repeat_heads(B, hg, 1).float()
        Ch = _repeat_heads(C, hg, 1).float()
        upd = Bh[..., :, None] * (xs.float() * dtv[..., None])[..., None, :]
        new_state = a[:, :, None, None] * ssm_st + upd
        y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
        y = y + blk["D"].float()[None, :, None] * xs.float()
        y = y.reshape(b, 1, dv)
        gated = y * F.silu(z.float())
        y = L.rms_norm(gated.to(xc.dtype), blk["ssm_norm"], cfg.norm_eps)
        out = xc + y @ blk["out_proj"]
        return (out,), (new_conv_st, new_state)

    (x,), (conv_new, state_new) = scan_layers(
        body, (x,), (params["blocks"], cache.conv, cache.state)
    )
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["unembed"].to(dtype)
    return logits[:, 0], SSMCache(conv_new, state_new, cache.length + 1)
