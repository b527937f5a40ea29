"""Mamba-2 (SSD — state-space duality) family (mamba2-780m), port of
``repro.models.ssm``.

The block follows arXiv:2405.21060: in_proj → depthwise causal conv (the
paper-technique stencil; on the card the B7 kernel
``csrc/conv1d_depthwise.cu``) → SSD sequence mixing in the chunked dual
form (intra-chunk quadratic attention-like matmuls + inter-chunk linear
recurrence) → gated RMSNorm → out_proj.

Both the chunked-parallel form (prefill and training, with ``lm_loss``
and the reference's selective remat) and the O(1)-state recurrent form
(decode) are here, with the reference's casts: the compute dtype
for matmul weights and activations, float32 for the norms, gates, the
SSD sums and the decode cache. Parameters are nested dicts of tensors,
blocks stacked along a leading layer axis, as in the reference.

Tensor parallelism (the ``tp`` profile's ``model`` axis, installed by
``distrib.sharding.set_rules`` / ``rules_context``): each rank holds its
blocks of the parameters exactly as the reference's ``PARAM_RULES`` cut
them (``in_proj``'s columns by divisibility alone, so a block may end
inside z or xBC; ``conv_w`` on its taps; ``conv_b`` on channels that
ignore the x/B/C boundaries; ``A_log``, ``D``, ``dt_bias``,
``ssm_norm`` and ``out_proj``'s rows by heads; the embedding by vocab,
``unembed`` on d_model), and computes this rank's heads
(:func:`_ssm_block_tp`): the ``in_proj`` columns it needs (its heads'
z, x and dt, and all of B and C, shared by every head of a group) from
the gathered weight, or from the gathered product when there are fewer
tokens than d_model; the conv taps and bias gathered and cut to its
channels; the conv through ``kops.conv1d_depthwise`` (B7 on the card)
on its ``[x of its heads, B, C]`` channels, a strided view of its
projection; the SSD, D and the z gate on its heads; the gated RMS norm
with its sum of squares summed over ``model``; ``out_proj``'s rows of
its heads, summed over ``model`` in float32. Where the heads do not
split over the ranks every rank computes every head and takes
``out_proj``'s rows of the result. Decode keeps the cache in the
reference's ``cache_shardings`` blocks: the conv window by channels
(gathered for the step, this rank's channels kept), the state by heads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import as_dtype, resolve_device
from repro_torch.distrib import sharding as shlib
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    cast_params,
    embed_tokens,
    remat_body,
    scan_layers,
    tp_logits,
)
from repro_torch.tree import path_str, tree_leaves_with_path

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


def _block_shapes(cfg: ModelConfig, n_layers: int) -> dict[str, tuple]:
    """Each stacked block leaf's shape."""
    d = cfg.d_model
    dv, h, p, g, n, conv_ch = _dims(cfg)
    in_dim = 2 * dv + 2 * g * n + h  # z, xBC, dt
    return {
        "ln1": (n_layers, d),
        "in_proj": (n_layers, d, in_dim),
        "conv_w": (n_layers, cfg.ssm_conv_kernel, conv_ch),
        "conv_b": (n_layers, conv_ch),
        "A_log": (n_layers, h),
        "D": (n_layers, h),
        "dt_bias": (n_layers, h),
        "ssm_norm": (n_layers, dv),
        "out_proj": (n_layers, dv, d),
    }


def init_block_params(cfg: ModelConfig, gen: torch.Generator,
                      n_layers: int) -> Params:
    shapes = _block_shapes(cfg, n_layers)
    dev = gen.device

    def zeros(name):
        return torch.zeros(shapes[name], device=dev)

    return {
        "ln1": zeros("ln1"),
        "in_proj": L.dense_init(gen, shapes["in_proj"]),
        "conv_w": L.dense_init(gen, shapes["conv_w"]),
        "conv_b": zeros("conv_b"),
        "A_log": zeros("A_log"),  # A = -exp(A_log) = -1
        "D": torch.ones(shapes["D"], device=dev),
        "dt_bias": zeros("dt_bias"),
        "ssm_norm": zeros("ssm_norm"),
        "out_proj": L.dense_init(gen, shapes["out_proj"]),
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


def abstract_params(cfg: ModelConfig) -> Params:
    """The tree :func:`init_params` makes, as float32 tensors on the
    ``meta`` device (shapes, no storage): the reference's
    ``launch.specs.abstract_params``, which the sharding rules read."""

    def meta(shape):
        return torch.empty(shape, dtype=f32, device="meta")

    return {
        "embed": meta((cfg.vocab, cfg.d_model)),
        "blocks": {k: meta(s) for k, s in
                   _block_shapes(cfg, cfg.n_layers).items()},
        "final_norm": meta((cfg.d_model,)),
        "unembed": meta((cfg.d_model, cfg.vocab)),
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
    # Masked before exp, out of place: above the diagonal A_cs_i − A_cs_j
    # is positive and overflows exp at a chunk of 256, and the
    # reference's exp-then-zero form then gives 0·inf = NaN gradients
    # (ROADMAP section C); exp(-inf) is an exact 0 with a zero gradient.
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    decay = (At[..., :, None] - At[..., None, :]).masked_fill(
        ~causal, float("-inf")).exp()
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


# --- tensor parallelism --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _TP:
    """This rank's part of mamba2 on the installed mesh's ``model`` axis.
    ``held[name]`` (``name`` the leaf's path under ``blocks``, or
    ``embed``, ``unembed``) is ``sharding.leaf_held``'s (how, per-layer
    dim): ``"cut"`` (this rank's block, of whole heads for the per-head
    leaves), ``"gather"`` or ``"whole"``; ``heads`` this rank's heads
    [lo, hi) (all of them where they do not split: ``split`` False);
    ``rows`` the d_inner channels [lo, hi) whose ``out_proj`` rows this
    rank multiplies."""

    axis: shlib.ModelAxis
    held: dict
    heads: tuple[int, int]
    split: bool
    rows: tuple[int, int]
    index: dict = dataclasses.field(default_factory=dict, compare=False)

    def columns(self, cfg: ModelConfig, device) -> tuple[torch.Tensor, ...]:
        """(the ``in_proj`` columns this rank computes: its heads' z, x,
        all of B and C, its heads' dt; the conv channels among them:
        its heads' x, then B and C), as index tensors on ``device``."""
        if device not in self.index:
            dv, h, p, g, n, conv_ch = _dims(cfg)
            lo, hi = self.heads
            xs = torch.arange(lo * p, hi * p, device=device)
            bc = torch.arange(dv, conv_ch, device=device)
            dt = torch.arange(lo, hi, device=device) + dv + conv_ch
            self.index[device] = (torch.cat([xs, dv + xs, dv + bc, dt]),
                                  torch.cat([xs, bc]))
        return self.index[device]


def _tp_plan(cfg: ModelConfig) -> _TP | None:
    """The installed rule set's tensor-parallel plan for ``cfg`` (from the
    reference's ``PARAM_RULES`` on the mesh); None without a ``tp`` rule
    set on a ``model`` axis above one rank."""
    axis = shlib.model_axis()
    if axis is None:
        return None
    plans = axis.mesh.__dict__.setdefault("_tp_plans", {})
    if cfg in plans:
        return plans[cfg]
    dv, h, p, g, n, conv_ch = _dims(cfg)
    units = {"ssm_norm": p, "out_proj": p}
    held = {}
    for path, leaf in tree_leaves_with_path(abstract_params(cfg)):
        path = path_str(path)
        name = path.removeprefix("blocks/")
        how, dim = shlib.leaf_held(path, tuple(leaf.shape),
                                   units.get(name, 1))
        if dim is not None and name != path:
            dim -= 1  # a block leaf's dim without its layer axis
        held[name] = (how, dim)
    m, r = axis.size, axis.index
    split = h % m == 0
    heads = (r * h // m, (r + 1) * h // m) if split else (0, h)
    plans[cfg] = _TP(axis, held, heads, split, (r * dv // m, (r + 1) * dv // m))
    return plans[cfg]


def _leaf_whole(tp: _TP, w: torch.Tensor, name: str) -> torch.Tensor:
    """The per-layer leaf ``name`` whole inside the region
    (``sharding.region_whole``)."""
    how, dim = tp.held[name]
    return shlib.region_whole(w, tp.axis, how, 0 if dim is None else dim)


def _leaf_slice(tp: _TP, w: torch.Tensor, name: str, lo: int, n: int,
                dim: int = -1):
    """``[lo, lo + n)`` along ``dim`` of the per-layer leaf ``name``
    inside the region (``sharding.region_slice``)."""
    return shlib.region_slice(w, tp.axis, tp.held[name][0], dim, lo, n)


def _in_proj_tp(xin: torch.Tensor, w: torch.Tensor, tp: _TP,
                cfg: ModelConfig, whole: bool) -> torch.Tensor:
    """``xin`` (b, l, d), entered into the region, times ``in_proj``: the
    columns this rank computes (``_TP.columns``), or every column
    (``whole``, decode). A cut ``in_proj`` is gathered for the product
    where the weight has fewer values than the product (b·l ≥ d),
    else the product of this rank's columns is (its gradient
    reduce-scattered back either way)."""
    cols = tp.columns(cfg, xin.device)[0]
    how = tp.held["in_proj"][0]
    b, l, d = xin.shape
    if how != "whole" and (whole or b * l < d):
        proj = shlib.gather_for_compute(xin @ w, tp.axis, -1)
        return proj if whole else proj.index_select(-1, cols)
    w = _leaf_whole(tp, w, "in_proj")
    return xin @ (w if whole else w.index_select(-1, cols))


def _conv_leaves_tp(blk: Params, tp: _TP, cfg: ModelConfig, dtype):
    """(conv_w (k, c), conv_b (c)) on this rank's conv channels, whole
    taps gathered (``conv_w`` is cut on its taps), in ``dtype``."""
    conv = tp.columns(cfg, blk["conv_b"].device)[1]
    w = _leaf_whole(tp, blk["conv_w"], "conv_w").index_select(-1, conv)
    bias = _leaf_whole(tp, blk["conv_b"], "conv_b").index_select(-1, conv)
    return w.to(dtype), bias.to(dtype)


def _per_head_groups(t: torch.Tensor, tp: _TP, cfg: ModelConfig, dim: int):
    """B or C (groups on ``dim``) for this rank's heads: as it is for one
    group, else each head's group."""
    dv, h, p, g, n, conv_ch = _dims(cfg)
    if g == 1:
        return t
    lo, hi = tp.heads
    groups = torch.arange(lo, hi, device=t.device) // (h // g)
    return t.index_select(dim, groups)


def _out_tp(gated: torch.Tensor, blk: Params, cfg: ModelConfig, tp: _TP
            ) -> torch.Tensor:
    """The gated RMS norm of this rank's heads' channels ``gated`` (in
    the compute dtype) over all of d_inner (its sum of squares summed
    over ``model`` where the heads split), then ``out_proj``'s rows of
    ``tp.rows``, summed over ``model`` in float32: the block's output,
    whole on every rank."""
    dv, h, p, g, n, conv_ch = _dims(cfg)
    first = tp.heads[0] * p
    xf = gated.float()
    ss = xf.square().sum(dim=-1, keepdim=True)
    if tp.split:
        ss = shlib.model_sum(ss, tp.axis)
    w = _leaf_slice(tp, blk["ssm_norm"], "ssm_norm", first, gated.shape[-1])
    y = (xf * torch.rsqrt(ss / dv + cfg.norm_eps) * (1.0 + w.float())
         ).to(gated.dtype)
    lo, hi = tp.rows
    w_out = _leaf_slice(tp, blk["out_proj"], "out_proj", lo, hi - lo, 0)
    return shlib.row_parallel(y.narrow(-1, lo - first, hi - lo), w_out,
                              tp.axis)


def _ssm_block_tp(x: torch.Tensor, blk: Params, cfg: ModelConfig, tp: _TP,
                  use_pallas_conv: bool) -> torch.Tensor:
    """:func:`ssm_block` on this rank's heads (the module docstring says
    how), its output summed over ``model``."""
    b, l, d = x.shape
    dv, h, p, g, n, conv_ch = _dims(cfg)
    lo, hi = tp.heads
    nz, gn = (hi - lo) * p, g * n
    proj = _in_proj_tp(shlib.into_region(x, tp.axis), blk["in_proj"], tp,
                       cfg, whole=False)
    z, xBC, dt = proj[..., :nz], proj[..., nz:2 * nz + 2 * gn], \
        proj[..., 2 * nz + 2 * gn:]
    conv_w, conv_b = _conv_leaves_tp(blk, tp, cfg, x.dtype)
    if use_pallas_conv:
        xBC = kops.conv1d_depthwise(xBC, conv_w, activation="none")
    else:
        xBC = kref.conv1d_depthwise_causal(xBC, conv_w)
    xBC = F.silu((xBC + conv_b).float()).to(x.dtype)
    xs = xBC[..., :nz].reshape(b, l, hi - lo, p)
    B = _per_head_groups(xBC[..., nz:nz + gn].reshape(b, l, g, n), tp, cfg, 2)
    C = _per_head_groups(xBC[..., nz + gn:].reshape(b, l, g, n), tp, cfg, 2)
    dt = F.softplus(dt.float() + _leaf_slice(
        tp, blk["dt_bias"], "dt_bias", lo, hi - lo).float())
    A = -torch.exp(_leaf_slice(tp, blk["A_log"], "A_log", lo, hi - lo).float())
    x_in = (xs.float() * dt[..., None]).to(x.dtype)
    y, _ = ssd_chunked(x_in, dt * A, B, C, min(cfg.ssm_chunk, l))
    D = _leaf_slice(tp, blk["D"], "D", lo, hi - lo).float()
    y = (y + D[None, None, :, None] * xs.float()).reshape(b, l, nz)
    gated = y * F.silu(z.float())
    return _out_tp(gated.to(x.dtype), blk, cfg, tp)


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           tp: _TP | None):
    axis = tp.axis if tp is not None and tp.held["embed"][0] != "whole" \
        else None
    return embed_tokens(params["embed"], tokens, as_dtype(cfg.dtype), axis)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
            tp: _TP | None):
    """The final norm and the unembedding: under ``tp`` this rank's vocab
    columns where ``unembed`` is cut (``transformer.tp_logits``)."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["unembed"].to(x.dtype)
    if tp is None or tp.held["unembed"][0] == "whole":
        return x @ w
    return tp_logits(x, w, tp.axis, rows=tp.held["unembed"][1] == 0)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            use_pallas_conv: bool | None = None):
    """Logits (b, s, vocab) in ``cfg.dtype`` and a zero aux loss.

    ``use_pallas_conv=None`` takes the B7 kernel when the tokens lie on
    the card and the plain conv on the CPU (the reference decides by
    backend, ``jax.default_backend() == "tpu"``).

    Under ``cfg.remat`` each layer runs through
    ``transformer.remat_body``: with grad mode on, the backward
    recomputes a layer from its input (``"selective"``: and its saved
    projections; B7 launches again there), as the reference's
    ``jax.checkpoint`` does. Under ``no_grad`` (serving) the layers run
    as they are.

    Under an installed ``tp`` rule set ``params`` are this rank's blocks
    and the logits its vocab columns where ``unembed`` is cut (the
    module docstring says how the ranks share a layer).
    """
    dtype = as_dtype(cfg.dtype)
    if use_pallas_conv is None:
        use_pallas_conv = tokens.device.type == "cuda"
    tp = _tp_plan(cfg)
    x = _embed(params, cfg, tokens, tp)

    def block(xc, blk):
        blk = cast_params(blk, dtype)
        xin = L.rms_norm(xc, blk["ln1"], cfg.norm_eps)
        if tp is not None:
            return xc + _ssm_block_tp(xin, blk, cfg, tp, use_pallas_conv)
        return xc + ssm_block(xin, blk, cfg, use_pallas_conv)

    layer = remat_body(block, cfg.remat)

    def body(xc, blk):
        return layer(xc, blk), 0.0

    x, _ = scan_layers(body, x, params["blocks"])
    logits = _logits(params, cfg, x, tp)
    return logits, torch.zeros((), dtype=f32, device=logits.device)


def lm_loss(params: Params, cfg: ModelConfig, batch: dict, *,
            use_pallas_conv: bool | None = None):
    """(mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` under the optional ``batch["loss_mask"]``,
    {"xent": the same}); ``use_pallas_conv`` goes to :func:`forward`.
    Under ``tp`` the cross-entropy is vocab-parallel where the logits
    are cut."""
    logits, _ = forward(params, cfg, batch["tokens"],
                        use_pallas_conv=use_pallas_conv)
    cut = logits.shape[-1] < cfg.vocab
    loss = L.token_xent(logits, batch["labels"], batch.get("loss_mask"),
                        vocab_axis=_tp_plan(cfg).axis if cut else None)
    return loss, {"xent": loss}


# --- decode ------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device | None = None) -> SSMCache:
    """An empty decode cache on ``device`` (the card by default). Under
    an installed ``tp`` rule set, this rank's block of the ``batch``
    cache by the reference's ``cache_shardings`` rules: the conv window
    by channels, the state by heads, the batch over the data axes."""
    del max_len  # O(1) state — the whole point of the SSM family
    dev = resolve_device(device)
    dv, h, p, g, n, conv_ch = _dims(cfg)
    conv = shlib.cache_block(
        "channels", (cfg.n_layers, batch, cfg.ssm_conv_kernel - 1, conv_ch))
    state = shlib.cache_block("ssm_state", (cfg.n_layers, batch, h, n, p))
    return SSMCache(
        conv=torch.zeros(conv, dtype=f32, device=dev),
        state=torch.zeros(state, dtype=f32, device=dev),
        length=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _decode_layer_tp(xc, blk, conv_st, ssm_st, cfg: ModelConfig, tp: _TP):
    """One token through a layer on this rank's heads: (out, this rank's
    conv window block, its heads' state). The whole projection is
    gathered (b tokens, fewer than d_model) and the conv window's
    channel blocks joined for the step; this rank keeps its channels."""
    b = xc.shape[0]
    dv, h, p, g, n, conv_ch = _dims(cfg)
    lo, hi = tp.heads
    nz, gn = (hi - lo) * p, g * n
    xin = shlib.into_region(L.rms_norm(xc, blk["ln1"], cfg.norm_eps),
                            tp.axis)
    z, xBC, dt = _split_in_proj(
        _in_proj_tp(xin, blk["in_proj"], tp, cfg, whole=True), cfg)
    held = conv_st.shape[-1]
    if held != conv_ch:
        conv_st = shlib.gather_for_compute(conv_st, tp.axis, -1)
    window = torch.cat([conv_st.to(xc.dtype), xBC], dim=1)  # (b, k, ch)
    new_conv_st = window[:, 1:].float().narrow(
        -1, tp.axis.index * held if held != conv_ch else 0, held)
    conv_w, conv_b = _conv_leaves_tp(blk, tp, cfg, xc.dtype)
    window = window.index_select(-1, tp.columns(cfg, xc.device)[1])
    conv = F.silu((torch.einsum("bkc,kc->bc", window, conv_w)
                   + conv_b).float()).to(xc.dtype)
    xs = conv[..., :nz].reshape(b, hi - lo, p)
    B = _per_head_groups(conv[..., nz:nz + gn].reshape(b, g, n), tp, cfg, 1)
    C = _per_head_groups(conv[..., nz + gn:].reshape(b, g, n), tp, cfg, 1)
    hg = (hi - lo) // B.shape[1]
    dtv = F.softplus(dt[:, 0, lo:hi].float() + _leaf_slice(
        tp, blk["dt_bias"], "dt_bias", lo, hi - lo).float())
    a = torch.exp(dtv * -torch.exp(_leaf_slice(
        tp, blk["A_log"], "A_log", lo, hi - lo).float()))
    Bh = _repeat_heads(B, hg, 1).float()
    Ch = _repeat_heads(C, hg, 1).float()
    upd = Bh[..., :, None] * (xs.float() * dtv[..., None])[..., None, :]
    new_state = a[:, :, None, None] * ssm_st + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    D = _leaf_slice(tp, blk["D"], "D", lo, hi - lo).float()
    y = (y + D[None, :, None] * xs.float()).reshape(b, 1, nz)
    gated = y * F.silu(z[..., lo * p:hi * p].float())
    return xc + _out_tp(gated.to(xc.dtype), blk, cfg, tp), new_conv_st, \
        new_state


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: SSMCache):
    """One recurrent decode step — O(1) in context length. ``tokens``
    (b, 1) → logits (b, vocab) in ``cfg.dtype`` and the next cache.

    Under an installed ``tp`` rule set ``params`` and ``cache`` are this
    rank's blocks (:func:`init_decode_cache`) and the logits its vocab
    columns where they are cut; each layer runs on this rank's heads
    (:func:`_decode_layer_tp`)."""
    dtype = as_dtype(cfg.dtype)
    b = tokens.shape[0]
    dv, h, p, g, n, conv_ch = _dims(cfg)
    hg = h // g
    tp = _tp_plan(cfg)
    x = _embed(params, cfg, tokens, tp)  # (b, 1, d)

    def body(carry, scanned):
        (xc,) = carry
        blk, conv_st, ssm_st = scanned
        blk = cast_params(blk, dtype)
        if tp is not None:
            out, new_conv_st, new_state = _decode_layer_tp(
                xc, blk, conv_st, ssm_st, cfg, tp)
            return (out,), (new_conv_st, new_state)
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
    logits = _logits(params, cfg, x, tp)
    return logits[:, 0], SSMCache(conv_new, state_new, cache.length + 1)
