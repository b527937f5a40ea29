"""Gradient synchronization and microbatch accumulation (port of
``repro.distrib.grad_sync``), over ``torch.distributed`` process groups
of a ``DeviceMesh`` (``launch/mesh.py``) instead of ``shard_map`` axes.
A mesh axis name stands for its dimension's group; a tuple of names
for the group over their product (``sharding.axis_group``).

* ``compressed_psum_tree`` — f32 gradients (plus the carried residual)
  cast to bf16 for the wire, summed, back to f32; the residual of the
  cast (computed before the sum, so local to each rank) is returned for
  the next step's error feedback.
* ``hierarchical_psum(_tree)`` — reduce-scatter within the fast group,
  all-reduce the 1/n shard over the slow group, all-gather within the
  fast group: the same sum, with 1/|fast| of the bytes on the slow
  links.
* ``accumulate_grads`` — a loop over the leading microbatch axis with
  float32 accumulators, returning the mean loss and mean gradients.
* ``sync_grads`` and ``global_norm`` — the data-parallel train step's
  sync (``launch.steps.make_train_step`` with a mesh): the sum of the
  ranks' weighted gradients over the data-parallel ranks, a flat bucketed f32
  all-reduce for leaves not cut over them (whole, or a tensor-parallel
  ``model`` block) and a reduce-scatter for leaves held as shards
  (ZeRO); and the global L2 norm over a tree of such leaves.

The collectives and their routes (gloo stages CUDA tensors through
pinned host memory) are ``distrib.comm``'s.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distrib import comm
from repro_torch.distrib.sharding import axis_group
from repro_torch.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_map_with_path,
)


def compressed_psum_tree(
    grads: Any,
    mesh,
    axis_name,
    *,
    error_feedback: Any | None = None,
) -> tuple[Any, Any]:
    """bf16-on-the-wire sum over ``axis_name`` of ``mesh`` with error
    feedback. Returns (synced f32 grads, new error-feedback residuals)."""
    group = axis_group(mesh, axis_name)
    gf = tree_map(lambda g: g.float(), grads)
    if error_feedback is not None:
        gf = tree_map(lambda g, e: g + e, gf, error_feedback)
    wire = tree_map(lambda g: g.to(torch.bfloat16), gf)
    resid = tree_map(lambda g, w: g - w.float(), gf, wire)
    comm.all_reduce_(tree_leaves(wire), group)
    return tree_map(lambda w: w.float(), wire), resid


def hierarchical_psum(x: torch.Tensor, mesh, fast_axis, slow_axis
                      ) -> torch.Tensor:
    """reduce-scatter(fast) → all-reduce(slow) → all-gather(fast).

    Equivalent to the sum over both axes; moves only 1/|fast| of the
    bytes over the slow links. Dim 0 is padded with zeros to a multiple
    of the fast group's size and cut back after."""
    fast, slow = axis_group(mesh, fast_axis), axis_group(mesh, slow_axis)
    n_fast = comm.group_size(fast)
    rows = x.shape[0]
    pad = (-rows) % n_fast
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    shard = comm.reduce_scatter(x.contiguous(), fast)
    comm.all_reduce_([shard], slow)
    full = comm.all_gather(shard, fast)
    return full[:rows] if pad else full


def hierarchical_psum_tree(grads: Any, mesh, fast_axis, slow_axis) -> Any:
    return tree_map(
        lambda g: hierarchical_psum(g, mesh, fast_axis, slow_axis), grads)


def accumulate_grads(
    loss_fn: Callable,
    params: Any,
    microbatches: Any,  # tree with leading (n_micro, ...) axes
) -> tuple[torch.Tensor, Any]:
    """Loop over the microbatches, accumulating f32 grads of
    ``loss_fn(params, microbatch) -> (loss, aux)``. Returns (mean loss,
    mean grads); ``params`` is left as it was."""
    n = tree_leaves(microbatches)[0].shape[0]
    paths = [path for path, _ in tree_leaves_with_path(params)]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_leaves(params)]
    loss_sum = torch.zeros((), dtype=torch.float32, device=acc[0].device)
    for i in range(n):
        mb = tree_map(lambda v: v[i], microbatches)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = loss_fn(leaves, mb)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
        acc = [a + g.float() for a, g in zip(acc, grads)]
        loss_sum = loss_sum + loss.detach().float()
    scale = 1.0 / n
    by_path = dict(zip(paths, acc))
    return loss_sum * scale, tree_map_with_path(
        lambda path, _: by_path[path] * scale, params)


# --- the data-parallel train step's sync --------------------------------------------


def _dp_cuts(sh, dp_axes, path) -> list:
    """The cuts of the sharding ``sh`` over data-parallel axes; a cut
    over other axes (``model``: a tensor-parallel block) is left out,
    one over both raises."""
    cuts = []
    for cut in sh.cuts():
        if set(cut.axes) <= set(dp_axes):
            cuts.append(cut)
        elif set(cut.axes) & set(dp_axes):
            raise ValueError(
                f"{'/'.join(path)} is cut over {cut.axes}, across the "
                f"data-parallel axes {tuple(dp_axes)} and others")
    return cuts


def sync_grads(grads: Any, shardings: Any, mesh, dp_axes) -> Any:
    """The data-parallel gradient: each rank's gradient (already weighted
    by its share), summed over the ranks of ``dp_axes``. ``grads`` are
    float32 tensors (overwritten), full over ``dp_axes`` (a tensor-parallel
    leaf is this rank's ``model`` block, summed as the block): a leaf
    not cut over ``dp_axes`` comes back as it is, summed by a flat
    bucketed all-reduce; a leaf cut over them (ZeRO) comes back as this
    rank's block, reduce-scattered over the cut's axes and all-reduced
    over the rest of ``dp_axes``."""
    dp_group = axis_group(mesh, dp_axes)
    cuts = {path: _dp_cuts(sh, dp_axes, path)
            for path, sh in tree_leaves_with_path(shardings)}
    flat = [g for path, g in tree_leaves_with_path(grads) if not cuts[path]]
    comm.all_reduce_(flat, dp_group)

    def one(path, g):
        if not cuts[path]:
            return g
        for cut in cuts[path]:
            moved = g.movedim(cut.dim, 0).contiguous()
            g = comm.reduce_scatter(moved, axis_group(mesh, cut.axes))
            g = g.movedim(0, cut.dim).contiguous()
        cut_axes = {a for cut in cuts[path] for a in cut.axes}
        rest = tuple(a for a in dp_axes if a not in cut_axes)
        comm.all_reduce_([g], axis_group(mesh, rest))
        return g

    return tree_map_with_path(one, grads)


def global_norm(grads: Any, shardings: Any, mesh) -> torch.Tensor:
    """The L2 norm of the full gradient tree, from leaves that are full
    (replicated) or this rank's blocks: the blocks' squared sums are
    summed over their cut axes' group (data, model, or both), the
    replicated leaves' added once. A float32 scalar, equal on every
    rank."""
    names = list(mesh.mesh_dim_names)
    by_path = dict(tree_leaves_with_path(shardings))
    leaves = tree_leaves_with_path(grads)
    dev = leaves[0][1].device
    full = torch.zeros((), dtype=torch.float32, device=dev)
    parts: dict[tuple, torch.Tensor] = {}
    for path, g in leaves:
        sq = g.float().square().sum()
        sh = by_path[path]
        if sh.replicated:
            full = full + sq
        else:
            axes = tuple(sorted({a for cut in sh.cuts() for a in cut.axes},
                                key=names.index))
            parts[axes] = parts.get(axes, torch.zeros_like(full)) + sq
    for axes, sq in parts.items():
        sq = sq.reshape(1).contiguous()
        comm.all_reduce_([sq], axis_group(mesh, axes))
        full = full + sq[0]
    return torch.sqrt(full)
