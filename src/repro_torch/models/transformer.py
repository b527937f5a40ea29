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


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of dicts, tuples, lists and NamedTuples of
    the same structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, (dict, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def scan_layers(body: Callable, x, stacked):
    """The reference's ``lax.scan`` over stacked layer params as a loop
    over the layer index: ``x, y_i = body(x, stacked[i])``; returns
    ``x`` and the ``y_i`` stacked along a new leading axis."""
    n = _first_leaf(stacked).shape[0]
    ys = []
    for i in range(n):
        x, y = body(x, tree_map(lambda p, i=i: p[i], stacked))
        ys.append(y)
    return x, tree_map(
        lambda *leaves: torch.stack([torch.as_tensor(v) for v in leaves]),
        *ys,
    )
