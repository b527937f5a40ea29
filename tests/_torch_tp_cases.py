"""Rank functions of the port's tensor-parallel tests
(``tests/test_torch_tp.py``), run in processes spawned by
``repro_torch.launch.mesh.run_on_mesh`` on CPU ranks over gloo.

This module imports torch and the port only (no JAX), so each spawned
rank starts light. Every rank builds the full parameters from the numpy
tree it is given and keeps its blocks (``shard_tree``), takes its rows
of the batch (whisper's ``frames`` too) and returns numpy arrays: the
whole-vocab logits of its rows, its cache blocks' shapes and the cache
gathered whole, the step's metrics and the gradients and parameters
gathered whole.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.registry import get_config, get_model, reduced_config
from repro_torch.distrib import sharding as shlib
from repro_torch.launch import steps
from repro_torch.models import encdec, moe
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves_with_path

AXES = ("data", "model")
# the batch (b, s), decode steps from an empty cache of MAX_LEN slots
# (a length every model axis here divides), AdamW of the one step
BATCH, SEQ, DECODE_STEPS, MAX_LEN = 4, 16, 8, 8
OPT = dict(lr_peak=3e-3, warmup_steps=1, total_steps=2)

# mesh shape -> {case: (arch, fields replaced on its reduced config,
# parts run, fsdp)}; each case's comment says which rule it reaches.
MESHES = {
    (1, 2): {
        # QKV bias, tied: wk/wv/bk/bv cut mid-head (1 KV head of 16)
        "qwen2.5-3b": ("qwen2.5-3b", {}, ("serve", "train"), False),
        # untied: unembed cut on d_model (the embed$ rule matches it)
        "llama3-8b": ("llama3-8b", {}, ("serve", "train"), False),
        # GeGLU, sqrt(d) after the vocab-parallel sum
        "gemma-2b": ("gemma-2b", {}, ("serve", "train"), False),
        # patches after the vocab-parallel sum, M-RoPE
        "qwen2-vl-7b": ("qwen2-vl-7b", {}, ("serve", "train"), False),
        # 2 KV heads: every leaf on head boundaries, the cache by heads
        "llama3-8b-kv2": ("llama3-8b", {"n_kv_heads": 2},
                          ("serve", "train"), False),
        # MoE, 8 experts on 2 ranks: EP (4 whole experts a rank), QK-norm
        "qwen3-moe-ep": ("qwen3-moe-30b-a3b", {}, ("serve", "train"), False),
        # in_proj's 304 columns in blocks of 152: rank 0 holds z and
        # xBC[0:24]; conv_w cut on its 4 taps, conv_b on 80 channels;
        # the conv window cached by channels, the state by heads
        "mamba2": ("mamba2-780m", {}, ("serve", "train"), False),
        # embed by vocab, unembed on d_model, every other leaf whole; the
        # cache's state and conv window by width, its one KV head whole
        "recurrentgemma-9b": ("recurrentgemma-9b", {}, ("serve", "train"),
                              False),
        # embed cut at vocab 512, w_in/w_out by columns/rows, attention on
        # each rank's 2 heads from whole leaves; the cache by heads
        "whisper-small": ("whisper-small", {}, ("serve", "train"), False),
    },
    (1, 4): {
        # 6 heads on 4 ranks: wq cut mid-head, every rank computes every
        # head and wo's rows slice them; the cache whole (data axis 1)
        "llama3-8b-h6": ("llama3-8b", {"n_heads": 6, "n_kv_heads": 2},
                         ("serve", "train"), False),
        # head_dim 18: wk (18 columns) does not split over 4, so it is
        # whole on every rank inside the attention region
        "llama3-8b-hd18": ("llama3-8b", {"head_dim": 18},
                           ("serve", "train"), False),
        # MoE, 2 experts top-1 on 4 ranks: E < m, so expert-TP (24 of the
        # 96 columns of every expert a rank, w_down's rows)
        "qwen3-moe-etp": ("qwen3-moe-30b-a3b", {"n_experts": 2, "top_k": 1},
                          ("serve", "train"), False),
        # in_proj in blocks of 76: the first cut falls inside z; conv_w one
        # tap a rank; 4 of the 16 heads a rank
        "mamba2-z": ("mamba2-780m", {}, ("serve", "train"), False),
        # an odd vocab: embed whole, as full whisper's 51865; one head a rank
        "whisper-v513": ("whisper-small", {"vocab": 513}, ("serve", "train"),
                         False),
    },
    (2, 2): {
        # tp x fsdp, as the reference shards qwen2.5-14b (FSDP = True)
        "qwen2.5-14b": ("qwen2.5-14b", {}, ("train",), True),
        # 1 KV head, batch over data: the cache cut by sequence
        "gemma-2b-seq": ("gemma-2b", {}, ("serve",), False),
        # MoE with the batch over 2 data ranks: GSPMD's groups are the
        # global batch's (64 tokens, 4 at decode), each spanning both
        # data ranks, gathered over them; its experts over model (EP)
        "mixtral-span": ("mixtral-8x7b", {}, ("serve", "train"), False),
        # tp x fsdp: in_proj, out_proj and the embeddings also cut over data
        "mamba2-fsdp": ("mamba2-780m", {}, ("serve", "train"), True),
        # the batch over data: each data rank's rows of the width-cut cache
        "recurrentgemma-serve": ("recurrentgemma-9b", {}, ("serve",), False),
    },
    (2, 1): {
        # MoE data-parallel: each rank's 32 tokens half of the global
        # group of 64, gathered over data; the aux over the whole group;
        # unequal loss masks (MASKS), so the ranks' token counts differ
        "qwen3-moe-dp": ("qwen3-moe-30b-a3b", {}, ("train",), False),
        # no model axis above one rank: the cache built under the rule
        # set holds this rank's 2 of the 4 rows (the ring of mixtral's
        # window)
        "mixtral-dp": ("mixtral-8x7b", {}, ("serve",), False),
    },
}

# case -> its batch's seed, where it is not the case's index
SEEDS = {"qwen3-moe-dp": 3}


def loss_mask(name: str):
    """The case's ``loss_mask`` (BATCH, SEQ) float32, or None: for
    ``qwen3-moe-dp`` ones on rows 0-1 (rank 0) and the first 4
    positions of rows 2-3 (rank 1)."""
    if name != "qwen3-moe-dp":
        return None
    mask = np.zeros((BATCH, SEQ), np.float32)
    mask[:2] = 1.0
    mask[2:, :4] = 1.0
    return mask


def config(arch: str, fields: dict):
    """The port's reduced ``arch`` with ``fields`` replaced (float32)."""
    return dataclasses.replace(reduced_config(get_config(arch)), **fields)


def flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(p): v.detach().double().numpy()
            for p, v in tree_leaves_with_path(tree)}


def _rows(mesh, batch: dict) -> dict:
    """This rank's rows of ``batch`` (numpy) by ``batch_spec``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = shlib.local_shard(
            t, shlib.batch_spec(k, t.shape, mesh), mesh).contiguous()
    return out


def new_cache(cfg, params, frames=None, device="cpu"):
    """An empty decode cache of ``BATCH`` rows and ``MAX_LEN`` slots (this
    rank's block under an installed rule set); whisper's is
    ``init_decode_cache`` of ``encode(frames)`` (``frames`` this rank's
    rows)."""
    if cfg.is_encdec:
        return encdec.init_decode_cache(
            params, cfg, encdec.encode(params, cfg, frames))
    return get_model(cfg).init_decode_cache(cfg, BATCH, MAX_LEN,
                                            device=device)


def cache_leaves(cache) -> dict:
    """{name: tensor} of a decode cache's per-layer leaves."""
    return {k: v for k, v in cache._asdict().items()
            if k not in ("length", "slots") and v is not None}


def _serve(mesh, cfg, full, rows) -> dict:
    """The prefill, then ``DECODE_STEPS`` decode steps of the rows'
    tokens from an empty cache, on this rank's blocks."""
    api = get_model(cfg)
    p_sh = shlib.param_shardings(api.abstract_params(cfg), mesh)
    params = shlib.shard_tree(full, p_sh)
    prompt = {k: v for k, v in rows.items() if k != "labels"}
    prefill = steps.make_prefill_step(cfg, mesh=mesh, device="cpu")
    rec = {}
    routes = moe_routes(lambda: rec.update(prefill=prefill(params,
                                                           prompt).numpy()))
    if cfg.family == "moe":
        rec["prefill_routes"] = routes
    with torch.no_grad(), shlib.rules_context(mesh):
        cache = new_cache(cfg, params, rows.get("frames"))
    frames = (None if not cfg.is_encdec else
              torch.empty((BATCH, cfg.encoder_seq, cfg.d_model),
                          device="meta"))
    c_sh = steps.cache_shardings(
        new_cache(cfg, api.abstract_params(cfg), frames, device="meta"), mesh)
    sh = cache_leaves(c_sh)
    rec["cache_spec"] = {k: v.spec for k, v in sh.items()}
    rec["cache_block"] = {k: tuple(v.shape) for k, v in
                          cache_leaves(cache).items()}
    slots = getattr(cache, "slots", None)
    rec["slots"] = None if slots is None else slots.tolist()
    serve = steps.make_serve_step(cfg, mesh=mesh, device="cpu")
    logits = []
    with torch.no_grad():
        for t in range(DECODE_STEPS):
            lg, cache = serve(params, cache,
                              {"tokens": rows["tokens"][:, t:t + 1]})
            logits.append(lg)
    rec["decode"] = torch.stack(logits, 1).numpy()
    rec["cache"] = {k: sh[k].gather(v).double().numpy()
                    for k, v in cache_leaves(cache).items()}
    rec["length"] = int(cache.length)
    return rec


def _train(mesh, cfg, full, rows, fsdp: bool) -> dict:
    """Step 0's synced gradient (gathered whole), then one AdamW step:
    its metrics and the parameters (gathered whole)."""
    p_sh, _ = steps.train_shardings(cfg, mesh, fsdp=fsdp)
    params = shlib.shard_tree(full, p_sh)
    loss, _, grads, _ = steps.make_synced_grad_step(
        cfg, mesh=mesh, fsdp=fsdp, device="cpu")(params, rows)
    rec = {"loss0": float(loss),
           "grads": flat(shlib.gather_tree(grads, p_sh)),
           "shard_shapes": {k: v.shape for k, v in flat(params).items()}}
    step = steps.make_train_step(cfg, AdamWConfig(**OPT), device="cpu",
                                 mesh=mesh, fsdp=fsdp)
    params, _, m = step(params, adamw_init(params), rows)
    rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               params=flat(shlib.gather_tree(params, p_sh)))
    return rec


def moe_routes(run) -> dict:
    """``run()`` under ``moe.recording``: the (token, choice) pairs routed
    and kept and every layer's choices (numpy)."""
    with moe.recording(keep_routes=True) as rec:
        run()
    return {"routed": int(rec["routed"]), "kept": int(rec["kept"]),
            "routes": [r.numpy() for r in rec["routes"]]}


def span_rank(mesh, arch: str, fields: dict, params_np, tokens):
    """The forward of this rank's rows of ``tokens`` (numpy, global) under
    the tp and the dp profile on ``mesh``: {profile: (the ranks that cut
    the batch, the logits of its rows, the recorded routes)}."""
    torch.set_num_threads(1)
    cfg = config(arch, fields)
    params = convert.model_params_from_numpy(params_np, device="cpu")
    tokens = torch.from_numpy(tokens)
    out = {}
    for profile in ("tp", "dp"):
        rows = shlib.local_shard(
            tokens, shlib.batch_spec("tokens", tokens.shape, mesh, profile),
            mesh).contiguous()
        with torch.no_grad(), shlib.rules_context(
                mesh, shlib.profile_act_rules(profile)):
            ranks = shlib.batch_ranks()
            logits = []
            routes = moe_routes(lambda: logits.append(
                tr.forward(params, cfg, rows)[0]))
        out[profile] = (ranks, logits[0].numpy(), routes)
    return out


def tp_rank(mesh, cases: dict, inputs: dict):
    """Each case of ``cases`` (``MESHES[shape]``) on this rank, from its
    numpy parameters and batch in ``inputs``."""
    torch.set_num_threads(1)
    out = {}
    for name, (arch, fields, parts, fsdp) in cases.items():
        cfg = config(arch, fields)
        params_np, batch = inputs[name]
        full = convert.model_params_from_numpy(params_np, device="cpu")
        rows = _rows(mesh, batch)
        rec = {}
        if "serve" in parts:
            rec.update(_serve(mesh, cfg, full, rows))
        if "train" in parts:
            rec.update(_train(mesh, cfg, full, rows, fsdp))
        out[name] = rec
    return out
