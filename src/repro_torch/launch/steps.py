"""Step makers (port of ``repro.launch.steps``): ``make_train_step``
(with its gradient half, ``make_grad_step``, and over a mesh
``make_synced_grad_step``), ``train_shardings``, ``cache_shardings``,
``make_prefill_step`` and ``make_serve_step``.

PyTorch runs eagerly, so there is no jit. ``jit_train_step``'s
semantics (GSPMD over a mesh with the reference's shardings) become
``make_train_step(..., mesh=...)``: every rank of a
``torch.distributed`` mesh (``launch.mesh``) holds its blocks of the
parameters (``train_shardings``: the ``tp`` profile cuts what the
reference's rules match over ``model``, ``fsdp=True`` adds ZeRO cuts
over ``data``), takes its rows of the global batch (ranks that differ
only in ``model`` take the same rows), computes its gradient under the
profile's rule set (tensor parallelism inside each family's model
code) and joins the data-parallel sum (``distrib.
grad_sync``). ``make_prefill_step(..., mesh=)`` and
``make_serve_step(..., mesh=)`` are ``jit_prefill_step`` and
``jit_serve_step``: this rank's parameter blocks (and cache block, by
``cache_shardings``) in, the whole vocab's float32 logits of its rows
out. Each maker fixes the device its step runs on (the card by
default; it raises without one unless the caller passes
``device="cpu"``) and refuses tokens elsewhere.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_model
from repro_torch.distrib import comm
from repro_torch.distrib import sharding as shlib
from repro_torch.distrib.grad_sync import global_norm, sync_grads
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecCache
from repro_torch.models.hybrid import HybridCache
from repro_torch.models.layers import KVCache
from repro_torch.models.ssm import SSMCache
from repro_torch.optim import AdamWConfig, OptState, adamw_update
from repro_torch.tree import tree_leaves, tree_map


def _tokens_on(batch: dict, device: torch.device) -> torch.Tensor:
    tokens = batch["tokens"]
    if tokens.device != device:
        raise ValueError(
            f"tokens are on {tokens.device}; this step runs on {device}"
        )
    return tokens


def _conv_switch(use_pallas_conv: bool | None) -> dict:
    """The keyword for mamba2's conv switch when the caller set it: a
    model without one (the transformer) then refuses it with a
    ``TypeError`` instead of ignoring it."""
    return {} if use_pallas_conv is None else {
        "use_pallas_conv": use_pallas_conv}


def make_grad_step(cfg: ModelConfig, *,
                   device: str | torch.device | None = None,
                   use_pallas_conv: bool | None = None):
    """``grad_step(params, batch)`` → (loss, metrics, grads): the
    reference's ``jax.value_and_grad(api.lm_loss, has_aux=True)``. The
    gradients (float32 for the float32 master parameters) come from one
    ``backward`` through leaves that alias ``params``; ``params`` is
    left as it was. ``use_pallas_conv``, when set, goes to mamba2's
    ``lm_loss`` (unset: the B7 kernel on the card, the plain conv on the
    CPU).

    ``weights`` (w_xent, w_aux), where given, makes the gradient that of
    ``w_xent · xent + w_aux · router_aux_weight · aux`` (the
    transformer's two terms; the other families' loss is their xent);
    the returned loss and metrics stay unweighted."""
    api = get_model(cfg)
    dev = resolve_device(device)
    conv = _conv_switch(use_pallas_conv)

    def grad_step(params, batch, weights=None):
        _tokens_on(batch, dev)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = api.lm_loss(leaves, cfg, batch, **conv)
        objective = loss
        if weights is not None:
            objective = weights[0] * metrics["xent"]
            if "aux" in metrics:
                objective = objective + (weights[1] * cfg.router_aux_weight
                                         * metrics["aux"])
        objective.backward()
        # a leaf the loss does not reach (a stack of no layers: the
        # hybrid's tail at a depth the pattern divides) gets zeros, as
        # jax.grad gives it
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad, leaves)
        return (loss.detach(),
                {k: v.detach() for k, v in metrics.items()}, grads)

    return grad_step


def train_shardings(cfg: ModelConfig, mesh, *, profile: str = "tp",
                    fsdp: bool = False):
    """(param shardings, optimizer-state shardings) of the train step on
    ``mesh``, as the reference's ``jit_train_step`` returns them: trees
    of ``distrib.sharding.NamedSharding`` from ``param_spec`` over the
    model's abstract parameters; the moments mirror the parameters, the
    step count is replicated. Every family has a tensor-parallel form
    for the ``tp`` profile's cuts over ``model``."""
    abstract = get_model(cfg).abstract_params(cfg)
    p_sh = shlib.param_shardings(abstract, mesh, fsdp=fsdp, profile=profile)
    return p_sh, OptState(step=shlib.NamedSharding(mesh, ()), mu=p_sh,
                          nu=p_sh)


def cache_shardings(cache, mesh):
    """The decode cache's shardings on ``mesh`` (the reference's
    ``cache_shardings``, ``repro.launch.steps:47``), a cache of the same
    type whose leaves are ``NamedSharding``: the batch over ``(pod,
    data)`` and, over ``model``, a transformer's KV cache by KV heads,
    else by sequence; mamba2's conv window by channels and its state by
    heads; the hybrid's RG-LRU state and conv window by width, its KV
    ring by heads (whole where one KV head does not split); whisper's
    self and cross K/V by heads (``sharding.CACHE_RULES``). The length
    is replicated. ``cache`` may hold meta tensors.

    Raises:
        TypeError: for a cache of no model family.
    """
    rules = {
        KVCache: {"k": "kv", "v": "kv"},
        SSMCache: {"conv": "channels", "state": "ssm_state"},
        HybridCache: {"lru_h": "width", "conv": "channels", "k": "heads",
                      "v": "heads"},
        EncDecCache: {"k": "heads", "v": "heads", "xk": "heads",
                      "xv": "heads"},
    }.get(type(cache))
    if rules is None:
        raise TypeError(f"no cache rule for {type(cache).__name__}")
    return type(cache)(**{
        name: shlib.NamedSharding(mesh, () if name not in rules else
                                  shlib.cache_spec(rules[name],
                                                   tuple(leaf.shape), mesh))
        for name, leaf in cache._asdict().items() if leaf is not None})


def _rule_set(mesh, profile: str = "tp", batch_rows: int | None = None):
    """The profile's rule set installed on ``mesh`` for a step's call
    (nothing without a mesh), with the global batch's rows where the
    caller gave them (``sharding.batch_cut``)."""
    if mesh is None:
        return contextlib.nullcontext()
    return shlib.rules_context(mesh, shlib.profile_act_rules(profile),
                               batch_rows=batch_rows)


def _whole_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """``logits`` (b, vocab or this rank's vocab columns) float32, joined
    over ``model`` where they are cut (inside the step's rule set)."""
    logits = logits.float()
    if logits.shape[-1] == cfg.vocab:
        return logits
    return shlib.gather_for_compute(logits, shlib.model_axis(), -1)


def make_synced_grad_step(cfg: ModelConfig, *, mesh, profile: str = "tp",
                          fsdp: bool = False,
                          device: str | torch.device | None = None,
                          batch_rows: int | None = None):
    """``synced_grad_step(params, batch)`` → (loss, metrics, grads,
    grad_norm) on one rank of ``mesh``: ``batch`` is this rank's rows of
    the global batch (``batch_spec``: ``BatchIterator(host_index=
    dp_index, host_count=dp_size)`` makes them; ranks that differ only
    in ``model`` take the same rows); ``params`` are this rank's blocks
    (``sharding.shard_tree`` of ``train_shardings``): under ``fsdp``
    the cuts over the data-parallel axes are all-gathered before the
    forward, the ``tp`` profile's cuts over ``model`` stay blocks, and
    the gradient runs under the profile's rule set (tensor parallelism
    in the model).

    The token counts are all-reduced first. Each rank then takes the
    gradient (:func:`make_grad_step`) of its cross-entropy weighted by
    its share of the global batch's tokens, plus its aux loss over the
    R data-parallel ranks' count, and the gradients are summed over
    those ranks (``grad_sync.sync_grads`` at weight 1: a flat bucketed
    f32 all-reduce, or a reduce-scatter to this rank's block under
    ``fsdp``; a ``model`` block is summed as the block). That is the
    reference's gradient of the global batch's ``xent +
    router_aux_weight · aux``: the xent is the mean over every rank's
    tokens, and the aux (a mean over groups) is the mean of the ranks'
    equal numbers of groups, or the same global value on every rank
    where the MoE's groups span the ranks (``models.moe`` gathers them;
    the gather's reduce-scatter then sums the gradients that reach
    other ranks' rows, already weighted). A rank whose mask keeps no
    token adds zero to the xent. The loss and metrics are global too.
    ``grad_norm`` is the global norm of a sharded tree (None when every
    leaf is full: AdamW takes it from the tree). ``batch_rows``, where
    given, is the global batch's row count: the ranks that cut it are
    then ``batch_spec``'s (``sharding.batch_cut``; without it every
    data-parallel rank holds its rows of a cut batch)."""
    grad_step = make_grad_step(cfg, device=device)
    p_sh, _ = train_shardings(cfg, mesh, profile=profile, fsdp=fsdp)
    axes = shlib.dp_axes(profile)
    group = shlib.axis_group(mesh, axes)
    ranks = math.prod(shlib.mesh_axis_sizes(mesh).get(a, 1) for a in axes)
    sharded = any(not sh.replicated for sh in tree_leaves(p_sh))

    def synced_grad_step(params, batch):
        full = shlib.gather_tree(params, p_sh, axes) if sharded else params
        mask = batch.get("loss_mask")
        dev = batch["labels"].device
        count = (mask.double().sum() if mask is not None else
                 torch.tensor(float(batch["labels"].numel()),
                              dtype=torch.float64, device=dev))
        total = count.reshape(1).clone()
        comm.all_reduce_([total], group)
        w_xent = (count / total[0].clamp_min(1.0)).float()
        w_aux = 1.0 / ranks
        with _rule_set(mesh, profile, batch_rows):
            loss, metrics, grads = grad_step(full, batch, (w_xent, w_aux))
        del full
        names = sorted(metrics)
        xent = metrics["xent"]
        parts = [w_xent * xent + w_aux * (loss - xent)]
        parts += [(w_aux if k == "aux" else w_xent) * metrics[k]
                  for k in names]
        stats = torch.stack([v.double() for v in parts])
        comm.all_reduce_([stats], group)
        loss, *means = stats.float().unbind()
        grads = sync_grads(grads, p_sh, mesh, axes)
        norm = global_norm(grads, p_sh, mesh) if sharded else None
        return loss, dict(zip(names, means)), grads, norm

    return synced_grad_step


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    device: str | torch.device | None = None,
                    mesh=None, profile: str = "tp", fsdp: bool = False,
                    donate: bool = False, batch_rows: int | None = None):
    """``train_step(params, opt_state, batch)`` → (params, opt_state,
    metrics): the gradient of ``lm_loss`` (:func:`make_grad_step`; for
    mamba2 the B7 kernel on the card), then one ``adamw_update``;
    metrics ``xent``, ``loss``, ``grad_norm`` and ``lr`` (and the
    transformer's ``aux``; tensors on the device, read by the caller
    when it wants). With ``donate`` (the reference's ``jit_train_step``
    donates its parameters and optimizer state) the update is written
    into the given ``params`` and ``opt_state``'s moments, so a step
    holds one copy of them: the caller must not read the old values.

    With ``mesh`` (a ``DeviceMesh`` over an initialized group) each rank
    runs the step of :func:`make_synced_grad_step`: ``profile`` ``"dp"``
    cuts the batch over every mesh axis, ``"tp"`` over ``(pod, data)``
    and the heads, FFN hidden and vocab over ``model``; ``fsdp`` adds
    the ZeRO cuts. The parameters and their moments are this rank's
    blocks (``train_shardings`` gives the layout; ``sharding.shard_tree``
    cuts a full tree to it), and AdamW updates the blocks, clipped by
    the global norm. Metrics are global and equal on every rank.
    ``batch_rows`` goes to :func:`make_synced_grad_step`."""
    if mesh is None:
        if fsdp:
            raise ValueError("fsdp=True needs a mesh")
        grad_step = make_grad_step(cfg, device=device)

        def train_step(params, opt_state, batch):
            loss, metrics, grads = grad_step(params, batch)
            params, opt_state, opt_metrics = adamw_update(
                opt_cfg, grads, opt_state, params, donate=donate
            )
            return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

        return train_step

    synced = make_synced_grad_step(cfg, mesh=mesh, profile=profile,
                                   fsdp=fsdp, device=device,
                                   batch_rows=batch_rows)

    def dp_train_step(params, opt_state, batch):
        loss, metrics, grads, norm = synced(params, batch)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, params, grad_norm=norm, donate=donate
        )
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return dp_train_step


def make_prefill_step(cfg: ModelConfig, *, mesh=None,
                      device: str | torch.device | None = None,
                      use_pallas_conv: bool | None = None,
                      batch_rows: int | None = None):
    """``prefill_step(params, batch)`` → the last position's logits
    (b, vocab) in float32; ``batch`` may carry the VLM's ``positions``
    and ``patch_embeds``, and carries whisper's ``frames``. ``use_pallas_conv``, when set, goes to
    mamba2's ``forward`` (unset: the B7 kernel on the card, the plain
    conv on the CPU).

    With ``mesh`` (``jit_prefill_step``): ``params`` are this rank's
    blocks (``shard_tree`` of ``param_shardings``, the ``tp`` profile),
    ``batch`` its rows, and the forward runs under the ``tp`` rule set;
    the last position's logits are gathered over ``model`` once, so
    every rank returns its rows' whole-vocab logits. Whisper's
    ``frames`` are this rank's rows too; its encoder runs under the rule
    set as well. ``batch_rows``, where given, is the global batch's row
    count (``sharding.batch_cut``: a batch ``batch_spec`` leaves whole
    is then held whole by every rank).
    """
    api = get_model(cfg)
    dev = resolve_device(device)
    conv = _conv_switch(use_pallas_conv)

    def prefill_step(params, batch):
        extra = {k: batch[k] for k in ("positions", "patch_embeds", "frames")
                 if k in batch}
        with _rule_set(mesh, batch_rows=batch_rows):
            logits, _ = api.forward(params, cfg, _tokens_on(batch, dev),
                                    **extra, **conv)
            return _whole_vocab(cfg, logits[:, -1])

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, mesh=None,
                    device: str | torch.device | None = None,
                    batch_rows: int | None = None):
    """``serve_step(params, cache, batch)`` → (logits (b, vocab) float32,
    next cache): one decode step of ``batch["tokens"]`` (b, 1).

    With ``mesh`` (``jit_serve_step``): ``params`` are this rank's
    blocks, ``cache`` its block (``init_decode_cache`` under the ``tp``
    rule set, or ``shard_tree`` of :func:`cache_shardings`), ``batch``
    its rows; the logits are gathered over ``model`` once, at the end.
    Whisper's cache (cross K/V included) is ``encdec.init_decode_cache``
    of the encoder's output, both under the rule set. ``batch_rows`` as
    :func:`make_prefill_step` takes it.
    """
    api = get_model(cfg)
    dev = resolve_device(device)

    def serve_step(params, cache, batch):
        with _rule_set(mesh, batch_rows=batch_rows):
            logits, cache = api.decode_step(
                params, cfg, _tokens_on(batch, dev), cache
            )
            return _whole_vocab(cfg, logits), cache

    return serve_step
