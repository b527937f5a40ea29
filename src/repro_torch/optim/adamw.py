"""AdamW with decoupled weight decay, global-norm clipping, and warmup +
cosine decay (port of ``repro.optim.adamw``, a copy: the port imports
nothing of ``repro``).

Functional, on the port's trees (nested dicts of tensors): each moment
has its parameter's shape, in float32; ``adamw_update`` returns new
trees and leaves its arguments as they were, unless the caller donates
them (the reference's ``donate_argnums``): then the new values are
written into the given parameters and moments, leaf by leaf, so a step
holds no second copy of them. Not ``torch.optim.AdamW``:
that scales the parameter by ``1 - lr·wd`` in a multiply of its own
before the moment step (other roundings than the reference's
``p - lr·(m̂/(√v̂ + ε) + wd·p)``) and decays every tensor of a group,
where this one skips the leaves ``_NO_DECAY`` names, as the reference
does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import (
    path_str,
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_map_with_path,
)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any  # tree like params, float32
    nu: Any


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then cosine decay to
    ``lr_min_ratio · lr_peak`` at ``total_steps``: a float32 scalar on
    ``step``'s device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    floor = cfg.lr_min_ratio
    return cfg.lr_peak * warm * (floor + (1.0 - floor) * cos)


def adamw_init(params: Any) -> OptState:
    """Zero float32 moments beside each parameter, step 0 on the first
    leaf's device."""
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
    )


def _clip_scale(grads: Any, max_norm: float,
                norm: torch.Tensor | None = None):
    """(the factor that scales ``grads`` to a global L2 norm of at most
    ``max_norm``, the norm before scaling): see
    :func:`clip_by_global_norm`."""
    if norm is None:
        norm = torch.sqrt(
            sum(g.float().square().sum() for g in tree_leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0), norm


def clip_by_global_norm(grads: Any, max_norm: float,
                        norm: torch.Tensor | None = None):
    """(grads scaled so that their global L2 norm is at most
    ``max_norm``, each in its own dtype; the norm before scaling, a
    float32 scalar). The squares are summed leaf by leaf in the
    reference's leaf order, unless the caller gives ``norm`` (a tree
    of shards whose norm spans every rank's)."""
    scale, norm = _clip_scale(grads, max_norm, norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


_NO_DECAY = ("ln", "norm", "bias", "b_", "bq", "bk", "bv", "bo", "A_log",
             "dt_bias", "D", "a_param", "pos")


def _decays(path: tuple[str, ...]) -> bool:
    """Whether the leaf at ``path`` (its keys, ``repro_torch.tree``) is
    weight-decayed: not when its last key contains a ``_NO_DECAY``
    name."""
    leaf = path_str(path).rsplit("/", 1)[-1]
    return not any(k in leaf for k in _NO_DECAY)


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, grads: Any, state: OptState, params: Any, *,
    grad_norm: torch.Tensor | None = None, donate: bool = False,
) -> tuple[Any, OptState, dict[str, torch.Tensor]]:
    """One AdamW step → (new_params, new_state, metrics {"grad_norm",
    "lr"}): the gradients clipped to ``cfg.clip_norm`` (leaf by leaf,
    as :func:`clip_by_global_norm` scales them), the step counted, the
    learning rate from :func:`cosine_schedule`. ``grad_norm``, when
    given, is the global norm clipping uses (the ZeRO step's, whose
    ``grads`` and ``params`` are this rank's shards). With ``donate``
    the new parameters and moments are written into ``params`` and
    ``state``'s moments (the same values), which come back."""
    scale, gnorm = _clip_scale(grads, cfg.clip_norm, grad_norm)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    g_by_path = dict(tree_leaves_with_path(grads))
    m_by_path = dict(tree_leaves_with_path(state.mu))
    v_by_path = dict(tree_leaves_with_path(state.nu))
    new_m, new_v = {}, {}

    def upd(path, p):
        g = g_by_path[path]
        gf = (g * scale).to(g.dtype).float()
        m, v = m_by_path[path], v_by_path[path]
        m_new = b1 * m + (1.0 - b1) * gf
        v_new = b2 * v + (1.0 - b2) * gf.square()
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if _decays(path):
            delta = delta + cfg.weight_decay * p.float()
        p_new = (p.float() - lr * delta).to(p.dtype)
        if donate:
            m_new, v_new, p_new = m.copy_(m_new), v.copy_(v_new), p.copy_(
                p_new)
        new_m[path], new_v[path] = m_new, v_new
        return p_new

    new_params = tree_map_with_path(upd, params)
    return (
        new_params,
        OptState(
            step,
            tree_map_with_path(lambda path, _: new_m[path], state.mu),
            tree_map_with_path(lambda path, _: new_v[path], state.nu),
        ),
        {"grad_norm": gnorm, "lr": lr},
    )
