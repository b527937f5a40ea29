"""Decoder-only transformer, dense, MoE and VLM families (port of
``repro.models.transformer``): qwen2.5-3b/14b, gemma-2b, llama3-8b,
mixtral-8x7b and qwen3-moe-30b-a3b (the MoE FFN of :mod:`.moe`, its aux
loss summed over the layers) and qwen2-vl-7b (M-RoPE, the vision
frontend stubbed by ``patch_embeds``).

Also the helpers mamba2 shares: ``cast_params``, ``scan_layers`` and
the remat policy (:func:`remat_body`).

Parameters are plain nested dicts of tensors whose blocks are stacked
along a leading layer axis, as in the reference; the layer loop is
:func:`scan_layers`. Every op runs in plain PyTorch: the reference
computes attention, RoPE and the MLPs in ``jnp``, outside any Pallas
kernel, so this path launches none of the port's CUDA kernels.

Tensor parallelism (the ``tp`` profile's ``model`` axis, installed by
``distrib.sharding.set_rules`` / ``rules_context`` on a mesh): where the
reference's GSPMD partitions by its annotations, each rank holds its
blocks of the parameters (``param_spec``) and computes Megatron-style:
the vocab-parallel embedding, then per layer the attention on this
rank's whole q heads (q head ``h`` reading KV head ``h // (H/G)``) and
the MLP on its hidden columns (the MoE FFN on its experts, or on its
columns of every expert: :func:`.moe.moe_ffn`), each a region entered by
``into_region`` and left by ``out_of_region`` (one all-reduce of the
row-parallel ``wo``/``w_down`` partial products, in float32, rounded
once to the activation dtype after the sum);
vocab-cut logits, reduced by ``layers.token_xent``. A leaf cut
mid-head is gathered for the layer (its gradient reduce-scattered
back); a leaf whole on every rank but used inside a region has its
gradient summed over ``model``. Where ``H`` does not split into whole
heads per rank, every rank computes every head and takes ``wo``'s rows
from the result. :func:`_tp_plan` holds these choices.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import as_dtype, resolve_device
from repro_torch.distrib import sharding as shlib
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.tree import (
    path_str,
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
        shapes["moe"] = moe.moe_shapes(cfg, n_layers)
    else:
        shapes.update(w_gate=(n_layers, d, cfg.d_ff),
                      w_up=(n_layers, d, cfg.d_ff),
                      w_down=(n_layers, cfg.d_ff, d))
    return shapes


_DRAWN = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router")


def _keeper(shardings) -> Callable:
    """``keep(path, leaf)``: the leaf, or with ``shardings`` (a tree of
    ``NamedSharding``) a copy of this rank's block of it alone, so that
    the full leaf can be freed before the next is drawn."""
    if shardings is None:
        return lambda path, leaf: leaf
    by_path = dict(tree_leaves_with_path(shardings))

    def keep(path, leaf):
        sh = by_path[path]
        return leaf if sh.replicated else sh.shard(leaf).clone(
            memory_format=torch.contiguous_format)

    return keep


def init_block_params(cfg: ModelConfig, gen: torch.Generator,
                      n_layers: int, keep: Callable | None = None) -> Params:
    """Stacked block params with leading (n_layers,) axis: the
    projections (the MoE's router and experts too) from ``dense_init``,
    norms and biases zero; each leaf through ``keep(path, leaf)`` as it
    is made (``("blocks", name)``, ``("blocks", "moe", name)``)."""
    keep = keep or _keeper(None)

    def make(path, shapes):
        if isinstance(shapes, dict):
            return {k: make(path + (k,), s) for k, s in shapes.items()}
        return keep(path, L.dense_init(gen, shapes) if path[-1] in _DRAWN
                    else torch.zeros(shapes, device=gen.device))

    return make(("blocks",), _block_shapes(cfg, n_layers))


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None,
                shardings: Any = None) -> Params:
    """Random init (the reference's shapes, scales and optional leaves:
    ``bq/bk/bv``, ``q_norm/k_norm``, no ``unembed`` when tied) from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card by
    default; it raises without one unless ``device="cpu"``). The draws
    differ from ``jax.random``'s: to compare with the reference, carry
    its parameters across with ``convert.model_params_from_numpy``.

    With ``shardings`` (``param_shardings`` of the mesh) each leaf is
    cut to this rank's block as soon as it is drawn: the blocks of the
    one-rank parameters, with one full leaf alive at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    keep = _keeper(shardings)
    params: Params = {
        "embed": keep(("embed",), L.dense_init(
            gen, (cfg.vocab, cfg.d_model), scale=cfg.d_model**-0.5)),
        "blocks": init_block_params(cfg, gen, cfg.n_layers, keep),
        "final_norm": torch.zeros((cfg.d_model,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = keep(("unembed",), L.dense_init(
            gen, (cfg.d_model, cfg.vocab)))
    return params


def abstract_params(cfg: ModelConfig) -> Params:
    """The tree :func:`init_params` makes, as float32 tensors on the
    ``meta`` device (shapes, no storage): the reference's
    ``launch.specs.abstract_params``, which the sharding rules read."""

    def meta(shape):
        if isinstance(shape, dict):
            return {k: meta(s) for k, s in shape.items()}
        return torch.empty(shape, dtype=f32, device="meta")

    params: Params = {
        "embed": meta((cfg.vocab, cfg.d_model)),
        "blocks": meta(_block_shapes(cfg, cfg.n_layers)),
        "final_norm": meta((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = meta((cfg.d_model, cfg.vocab))
    return params


# --- tensor parallelism --------------------------------------------------------

# The leaves cut by heads (their unit: one head's columns or rows).
_HEAD_LEAVES = ("wq", "wk", "wv", "bq", "bk", "bv", "wo")


@dataclasses.dataclass(frozen=True)
class _TP:
    """This rank's part of the model on the installed mesh's ``model``
    axis. ``leaf[name]`` (``name`` the leaf's path under ``blocks``:
    ``wq``, ``moe/w_gate``; or ``embed``, ``unembed``) is ``"cut"``
    (this rank's block of whole units), ``"gather"`` (cut mid-head:
    joined for the layer) or ``"whole"`` (the same on every rank);
    ``attn`` / ``mlp`` / ``vocab`` say whether ``wo`` / ``w_down`` / the
    embedding is cut, which makes the attention, the MLP and the vocab
    Megatron regions; ``moe`` how the experts are cut (``"experts"``:
    EP, ``"hidden"``: expert-TP, None: whole); ``q`` is the global q
    heads this rank computes, ``kv_map`` the KV head of each;
    ``unembed_rows`` that an untied ``unembed`` is cut on d_model (the
    reference's ``embed$`` rule matches it first)."""

    axis: shlib.ModelAxis
    leaf: dict
    attn: bool
    mlp: bool
    vocab: bool
    q: tuple[int, int]
    kv_map: tuple[int, ...]
    unembed_rows: bool
    moe: str | None = None

    @property
    def kv(self) -> tuple[int, int]:
        """The KV heads this rank's q heads read."""
        return self.kv_map[0], self.kv_map[-1] + 1


def _tp_plan(cfg: ModelConfig) -> _TP | None:
    """The installed rule set's tensor-parallel plan for ``cfg``, from the
    reference's ``PARAM_RULES`` on the mesh (``sharding.leaf_cut``); None
    without a ``tp`` rule set on a ``model`` axis above one rank."""
    axis = shlib.model_axis()
    if axis is None:
        return None
    plans = axis.mesh.__dict__.setdefault("_tp_plans", {})
    if cfg in plans:
        return plans[cfg]
    shapes = {path_str(p): tuple(v.shape)
              for p, v in tree_leaves_with_path(abstract_params(cfg))}
    leaf, dims = {}, {}
    for path, shape in shapes.items():
        name = path.removeprefix("blocks/")
        leaf[name], dims[name] = shlib.leaf_held(
            path, shape, cfg.hd if name in _HEAD_LEAVES else 1)
    h, g, m, r = cfg.n_heads, cfg.n_kv_heads, axis.size, axis.index
    attn = leaf["wo"] != "whole"
    q = (r * h // m, (r + 1) * h // m) if leaf["wq"] == "cut" else (0, h)
    # EP cuts the experts (dim 1 of every expert leaf), expert-TP their
    # hidden width (w_gate/w_up's columns, w_down's rows)
    experts = {1: "experts", 3: "hidden"}.get(dims.get("moe/w_gate"))
    plans[cfg] = _TP(axis, leaf, attn, leaf.get("w_down", "whole") != "whole",
                     leaf["embed"] != "whole", q,
                     tuple(i // (h // g) for i in range(*q)),
                     dims.get("unembed") == 0, experts)
    return plans[cfg]


def _heads_of(tp: _TP, w: torch.Tensor, name: str, heads, hd: int):
    """The last-dim columns of ``heads`` (a global [lo, hi)) of the
    per-layer leaf ``name`` (heads of ``hd``): from this rank's block
    where it holds them, else from the whole leaf (gathered when cut
    mid-head; summed over ``model`` in the backward when whole)."""
    lo, hi = heads
    return shlib.region_slice(w, tp.axis, tp.leaf[name], -1, lo * hd,
                              (hi - lo) * hd)


def _qkv_tp(x, blk, cfg: ModelConfig, tp: _TP, kv: tuple[int, int]):
    """q for this rank's q heads and k, v for the KV heads ``kv``, inside
    the attention region."""
    b, s, _ = x.shape
    x = shlib.into_region(x, tp.axis)
    hd = cfg.hd
    q = x @ _heads_of(tp, blk["wq"], "wq", tp.q, hd)
    k = x @ _heads_of(tp, blk["wk"], "wk", kv, hd)
    v = x @ _heads_of(tp, blk["wv"], "wv", kv, hd)
    if cfg.qkv_bias:
        q = q + _heads_of(tp, blk["bq"], "bq", tp.q, hd)
        k = k + _heads_of(tp, blk["bk"], "bk", kv, hd)
        v = v + _heads_of(tp, blk["bv"], "bv", kv, hd)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, shlib.into_region(blk["q_norm"], tp.axis),
                       cfg.norm_eps)
        k = L.rms_norm(k, shlib.into_region(blk["k_norm"], tp.axis),
                       cfg.norm_eps)
    return q, k, v


def _kv_for_q(tp: _TP, t: torch.Tensor, first: int) -> torch.Tensor:
    """``t`` (b, L, g', dh) holding KV heads from ``first`` on, as one
    head per q head of this rank (dim 2 indexed by ``kv_map``)."""
    index = torch.tensor([i - first for i in tp.kv_map], device=t.device)
    return t.index_select(2, index)


def _wo_rows(tp: _TP, cfg: ModelConfig, out: torch.Tensor, first: int,
             wo: torch.Tensor) -> torch.Tensor:
    """``wo``'s row-parallel product, summed over ``model``: ``out`` (b,
    s, heads x dh) holds heads from ``first`` on; this rank's block of
    ``wo`` takes its rows' columns of it."""
    width = cfg.n_heads * cfg.hd // tp.axis.size
    part = out.narrow(-1, tp.axis.index * width - first * cfg.hd, width)
    return shlib.row_parallel(part, wo, tp.axis)


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
                    cos, sin, tp: _TP | None = None) -> torch.Tensor:
    """Training/prefill self-attention with RoPE and GQA, dispatched as
    the reference's: materialised at s ≤ 2048; above it the streaming
    form on chunks of 1024, or banded (KV chunk = window) when a
    sliding window divides s. Under ``tp``'s attention region, this
    rank's q heads, then ``wo``'s rows summed over ``model``."""
    region = tp is not None and tp.attn
    if region:
        q, k, v = _qkv_tp(x, blk, cfg, tp, tp.kv)
        k, v = (_kv_for_q(tp, t, tp.kv[0]) for t in (k, v))
    else:
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
    out = out.reshape(b, s, -1)
    if region:
        return _wo_rows(tp, cfg, out, tp.q[0], blk["wo"])
    return out @ blk["wo"]


def ffn_block(x, blk, cfg: ModelConfig, tp: _TP | None = None):
    """(the FFN's output, its aux loss: the MoE router's, zero for the
    dense MLP). Under ``tp``'s MLP region ``w_gate``/``w_up`` are this
    rank's columns and ``w_down`` its rows, the product summed over
    ``model``; the MoE FFN runs on this rank's experts or expert columns
    (``tp.moe``)."""
    if cfg.family == "moe":
        if tp is not None and tp.moe is not None:
            return moe.moe_ffn(x, blk["moe"], cfg, axis=tp.axis, cut=tp.moe)
        return moe.moe_ffn(x, blk["moe"], cfg)
    aux = torch.zeros((), dtype=f32, device=x.device)
    if tp is not None and tp.mlp:
        x = shlib.into_region(x, tp.axis)
        hidden = L.gated_hidden(x, blk["w_gate"], blk["w_up"], cfg.mlp)
        return shlib.row_parallel(hidden, blk["w_down"], tp.axis), aux
    return L.gated_mlp(x, blk["w_gate"], blk["w_up"], blk["w_down"],
                       cfg.mlp), aux


def decoder_block(x, blk, cfg: ModelConfig, cos, sin, tp: _TP | None = None):
    h = x + attention_block(L.rms_norm(x, blk["ln1"], cfg.norm_eps), blk,
                            cfg, cos, sin, tp)
    ff, aux = ffn_block(L.rms_norm(h, blk["ln2"], cfg.norm_eps), blk, cfg,
                        tp)
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
                 patch_embeds: torch.Tensor | None = None,
                 tp: _TP | None = None) -> torch.Tensor:
    """Token embedding in ``cfg.dtype``; for the VLM family the stubbed
    vision frontend's ``patch_embeds`` (b, n_patches, d) REPLACE the
    first n_patches positions; gemma scales by √d (in the compute
    dtype). Under ``tp``'s vocab cut the lookup is vocab-parallel
    (:func:`embed_tokens`), before the patches and the scale."""
    dtype = as_dtype(cfg.dtype)
    x = embed_tokens(params["embed"], tokens, dtype,
                     tp.axis if tp is not None and tp.vocab else None)
    if cfg.family == "vlm" and patch_embeds is not None:
        n_p = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(dtype), x[:, n_p:]], dim=1)
    if cfg.family == "dense" and cfg.arch_id.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dtype, device=x.device)
    return x


def _unembed(params: Params, cfg: ModelConfig, x: torch.Tensor,
             tp: _TP | None = None):
    """The logits. Under ``tp`` where the vocab can be cut, this rank's
    vocab columns of them (:func:`tp_logits`): tied models use their
    rows of ``embed``, transposed; an ``unembed`` cut on d_model is
    gathered for the product, or row-parallel into whole logits."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    unembed, name = params.get("unembed"), "unembed"
    if unembed is None:
        unembed, name = params["embed"].T, "embed"
    if tp is None or tp.leaf[name] == "whole":
        return x @ unembed.to(x.dtype)
    return tp_logits(x, unembed.to(x.dtype), tp.axis,
                     rows=name == "unembed" and tp.unembed_rows)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, dtype,
                 axis: shlib.ModelAxis | None = None) -> torch.Tensor:
    """``embed[tokens]`` in ``dtype``. With ``axis`` ``embed`` is this
    rank's block of vocab rows: each rank looks up the ids in its rows
    (zero elsewhere) and the rows are summed over ``model`` (exact: one
    rank holds each id)."""
    if axis is None:
        return embed[tokens].to(dtype)
    rows = embed.shape[0]
    local = tokens - axis.index * rows
    held = (local >= 0) & (local < rows)
    x = embed[local.clamp(0, rows - 1)] * held[..., None]
    return shlib.out_of_region(x.to(dtype), axis)


def tp_logits(x: torch.Tensor, w: torch.Tensor, axis: shlib.ModelAxis, *,
              rows: bool) -> torch.Tensor:
    """The logits of the whole ``x`` against this rank's block ``w`` of a
    (d_model, vocab) unembedding: its vocab columns (``rows=False``),
    which gives this rank's vocab columns of the logits; or its d_model
    rows (``rows=True``), gathered for the product (its gradient
    reduce-scattered back: one rank's columns each, so exact in any
    dtype) into the same vocab columns. With fewer tokens than d_model
    (decode), or a vocab that does not split, the rows are
    row-parallel instead: this rank's d_model slice of ``x`` times
    them, summed over ``model`` into whole logits."""
    x = shlib.into_region(x, axis)
    if rows:
        d_rows, vocab = w.shape
        m = axis.size
        if vocab % m or x.shape[0] * x.shape[1] < d_rows * m:
            part = x.narrow(-1, axis.index * d_rows, d_rows)
            return shlib.row_parallel(part, w, axis)
        w = shlib.gather_for_compute(w, axis, 0).narrow(
            1, axis.index * (vocab // m), vocab // m)
    return x @ w


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            patch_embeds: torch.Tensor | None = None):
    """Full forward pass → (logits (b, s, vocab) in ``cfg.dtype``, the
    MoE aux loss summed over the layers: zero for the dense FFN).
    ``positions`` (b, s), or (3, b, s) for M-RoPE, default to 0..s-1.
    Under ``cfg.remat`` each layer runs through :func:`remat_body`.
    Under an installed ``tp`` rule set ``params`` are this rank's blocks
    and the logits its vocab columns where the vocab is cut."""
    dtype = as_dtype(cfg.dtype)
    b, s = tokens.shape
    tp = _tp_plan(cfg)
    x = embed_inputs(params, cfg, tokens, patch_embeds, tp)
    cos, sin = _rope_tables(cfg, positions, b, s, tokens.device)

    def block(xc, blk):
        return decoder_block(xc, cast_params(blk, dtype), cfg, cos, sin, tp)

    x, auxes = scan_layers(remat_body(block, cfg.remat), x, params["blocks"])
    return _unembed(params, cfg, x, tp), auxes.sum()


def lm_loss(params: Params, cfg: ModelConfig, batch: dict):
    """(next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` under the optional ``loss_mask``, plus the
    router's weighted aux loss; {"xent", "aux"}). ``batch`` may carry
    ``positions`` and ``patch_embeds``. Under ``tp`` the cross-entropy
    is vocab-parallel where the logits are cut."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          positions=batch.get("positions"),
                          patch_embeds=batch.get("patch_embeds"))
    cut = logits.shape[-1] < cfg.vocab
    xent = L.token_xent(logits, batch["labels"], batch.get("loss_mask"),
                        vocab_axis=_tp_plan(cfg).axis if cut else None)
    loss = xent + cfg.router_aux_weight * aux
    return loss, {"xent": xent, "aux": aux}


# --- decode ------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: str | torch.dtype | None = None,
                      device: str | torch.device | None = None
                      ) -> L.KVCache:
    """An empty KV cache on ``device`` (the card by default), bf16 for a
    bf16 config; sliding-window configs get a ring of ``sliding_window``
    slots, so decode stays O(w) at any context. Under an installed
    ``tp`` rule set, this rank's block of the (``batch``, ``max_len``)
    cache by the reference's ``cache_shardings`` rule
    (``sharding.kv_cache_spec``): KV heads over ``model``, else the
    sequence (``slots`` then holds the block's global positions,
    ``sharding.kv_slots``); with
    no ``model`` axis above one rank, its rows of the batch
    (``sharding.cache_block``)."""
    dev = resolve_device(device)
    dt = as_dtype(dtype or cfg.dtype)
    cache_len = (min(cfg.sliding_window, max_len) if cfg.sliding_window
                 else max_len)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    slots = None
    axis = shlib.model_axis()
    if axis is not None:
        sh = shlib.NamedSharding(axis.mesh,
                                 shlib.kv_cache_spec(shape, axis.mesh))
        shape = shlib.block_shape(shape, sh.spec, axis.mesh)
        slots = shlib.kv_slots(sh, shape[2], dev)
    else:
        shape = shlib.cache_block("kv", shape)
    return L.KVCache(
        k=torch.zeros(shape, dtype=dt, device=dev),
        v=torch.zeros(shape, dtype=dt, device=dev),
        length=torch.zeros((), dtype=torch.int32, device=dev),
        slots=slots,
    )


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: L.KVCache):
    """One decode step: ``tokens`` (b, 1) at position ``cache.length``
    written into its slot (the ring's ``length mod size`` for a window,
    else ``length``, held to the last slot when full as the reference's
    ``dynamic_update_slice`` is), attended against the valid entries →
    (logits (b, vocab) in ``cfg.dtype``, the next cache). Runs on the
    device without reading the length back to the host.

    Under an installed ``tp`` rule set ``params`` and ``cache`` are
    this rank's blocks and the logits its vocab columns. A cache cut by
    heads holds this rank's KV heads; one cut by sequence (``slots``)
    holds every KV head of its slots: the rank that owns the token's
    slot writes it, q is gathered for every head, and the softmax is
    merged over ``model`` (``layers.decode_attention``)."""
    dtype = as_dtype(cfg.dtype)
    b = tokens.shape[0]
    tp = _tp_plan(cfg)
    x = embed_inputs(params, cfg, tokens, tp=tp)
    length = cache.length.long()
    cos, sin = _rope_tables(cfg, length.expand(b, 1), b, 1, tokens.device)

    held = cache.k.shape[2]
    seq = cache.slots is not None
    size = held * tp.axis.size if seq else held
    ring = cfg.sliding_window is not None and size <= cfg.sliding_window
    slot = (length % size if ring else length.clamp(max=size - 1)).view(1)
    valid = length.clamp(max=size - 1) + 1 if ring else length + 1
    owned = None
    if seq:
        slot = slot - cache.slots[0]
        owned = (slot >= 0) & (slot < held)
        slot = slot.clamp(0, held - 1)
    # the KV heads this rank's cache block holds
    kv = ((0, cfg.n_kv_heads) if cache.k.shape[3] == cfg.n_kv_heads
          else tp.kv)
    window = None if ring else cfg.sliding_window

    def write(c, new):
        new = new.to(c.dtype)
        if owned is not None:
            new = torch.where(owned, new, c.index_select(1, slot))
        return c.index_copy(1, slot, new)

    def body(carry, scanned):
        (xc,) = carry
        blk, k_cache, v_cache = scanned
        blk = cast_params(blk, dtype)
        xin = L.rms_norm(xc, blk["ln1"], cfg.norm_eps)
        region = tp is not None and tp.attn
        if region:
            q, k, v = _qkv_tp(xin, blk, cfg, tp, kv)
            first = tp.q[0]
        else:
            q, k, v = _qkv(xin, blk, cfg)
            first = 0
        if cfg.rope_style != "none":
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
        k_cache = write(k_cache, k)
        v_cache = write(v_cache, v)
        # Ring eviction already enforces the window; absolute RoPE keeps
        # scores position-correct regardless of slot order.
        if seq:
            if q.shape[2] != cfg.n_heads:
                q, first = shlib.gather_for_compute(q, tp.axis, 2), 0
            out = L.decode_attention(q, k_cache, v_cache, valid,
                                     window=window, slots=cache.slots,
                                     seq_axis=tp.axis)
        elif region:
            out = L.decode_attention(q, _kv_for_q(tp, k_cache, kv[0]),
                                     _kv_for_q(tp, v_cache, kv[0]), valid,
                                     window=window)
        else:
            out = L.decode_attention(q, k_cache, v_cache, valid,
                                     window=window)
        out = out.reshape(b, 1, -1)
        if region:
            h = xc + _wo_rows(tp, cfg, out, first, blk["wo"])
        else:
            h = xc + out @ blk["wo"]
        ff, _ = ffn_block(L.rms_norm(h, blk["ln2"], cfg.norm_eps), blk, cfg,
                          tp)
        return (h + ff,), (k_cache, v_cache)

    (x,), (k_new, v_new) = scan_layers(
        body, (x,), (params["blocks"], cache.k, cache.v))
    logits = _unembed(params, cfg, x, tp)
    return logits[:, 0], L.KVCache(k_new, v_new, cache.length + 1,
                                   cache.slots)
