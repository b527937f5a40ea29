"""Helpers of the reference's decoder-only transformer that mamba2
uses (port of ``repro.models.transformer``): ``cast_params`` and
``scan_layers``. The dense transformer itself waits for ROADMAP A13.

Parameters are plain nested dicts of tensors whose blocks are stacked
along a leading layer axis, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import as_dtype
from repro_torch.tree import (
    tree_leaves_with_path,
    tree_map,
    tree_map_with_path,
)

Params = dict[str, Any]

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
