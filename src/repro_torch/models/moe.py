"""Mixture-of-Experts FFN (port of ``repro.models.moe``): mixtral-8x7b
and qwen3-moe-30b-a3b.

The reference's GShard/Switch grouped-einsum formulation, step for
step: the tokens are split into groups (:func:`group`), a softmax
router picks each token's top-k experts (:func:`router_topk`), a
capacity-bounded one-hot dispatch tensor (G, Tg, E, C) routes each
group's tokens to expert slots, the experts' gated FFNs run as batched
einsums over (E, C) slots, and the combine tensor (the dispatch scaled
by the gates) sums the slots back per token. Every product is a plain
einsum: the reference computes the router, the dispatch and the experts
in ``jnp``, outside any Pallas kernel, so this path launches none of the
port's CUDA kernels.

The (G, Tg, K, E, C) slot tensor the reference sums over K is never
built: a token's K choices name K different experts, so for each
(token, expert) at most one choice is live, and the dispatch is the
one-hot of that choice's slot (a comparison, no integer one-hot). The
sums over K the reference takes have one nonzero term, so the result
is the same bit for bit.

Tensor parallelism (the ``tp`` profile's ``model`` axis,
``distrib.sharding``): the router is whole on every rank and every rank
computes the same routing from the same tokens; then, inside a region
entered by the tokens and the gates (``into_region``: their gradients,
partial on each rank, summed over ``model``), each rank runs either its
E/m experts' slots (EP, ``cut="experts"``) or its f/m columns of every
expert and its rows of ``w_down`` (expert-TP, ``cut="hidden"``), and the
ranks' partial outputs are summed once in float32 and rounded once to
the compute dtype (``out_of_region``).

The groups are GSPMD's, over the global batch's tokens in order: on a
mesh whose data-parallel ranks cut the batch (``sharding.batch_cut``),
the group size is that of the global token count, and where a group
spans ranks each rank gathers every rank's rows (``sharding.
gather_rows``: its gradient a reduce-scatter), routes all the global
groups (so the aux loss is the global batch's, the same on every rank,
and counted once in the data-parallel mean), runs the dispatch, the
experts and the combine on the groups that hold its own rows, and keeps
those rows. This is the correct form, not the fast one: every rank
routes the whole batch, and the rows move by an all-gather, not an
all-to-all of the dispatched slots.

Each call's parts run under ``torch.profiler.record_function`` ranges
(``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``), so
a trace splits the device time between the dispatch and combine
einsums and the expert GEMMs (``tools/profile_dense.py --arch``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.distrib import sharding as shlib
from repro_torch.models.config import ModelConfig

f32 = torch.float32

GROUP_SIZE = 1024

_STATE = threading.local()


def moe_shapes(cfg: ModelConfig, n_layers: int) -> dict[str, tuple]:
    """The stacked MoE leaves' shapes, in the reference's draw order."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    return {
        "router": (n_layers, d, E),
        "w_gate": (n_layers, E, d, f),
        "w_up": (n_layers, E, d, f),
        "w_down": (n_layers, E, f, d),
    }


def group_size_for(t: int, group_size: int = GROUP_SIZE) -> int:
    """The largest group of at most ``group_size`` tokens that divides
    ``t``: the reference's ``while t % tg`` walk down from
    ``min(group_size, t)``."""
    tg = min(group_size, t)
    while t % tg:
        tg -= 1
    return tg


def group(x: torch.Tensor, group_size: int = GROUP_SIZE):
    """(b, s, d) → ((G, Tg, d), Tg) with Tg | b·s."""
    b, s, d = x.shape
    tg = group_size_for(b * s, group_size)
    return x.reshape(b * s // tg, tg, d), tg


def router_topk(logits: torch.Tensor, k: int):
    """Softmax router with renormalized top-k gates: logits (G, T, E) →
    (gates (G, T, k), idx (G, T, k), probs (G, T, E)). The choices come
    in ``lax.top_k``'s order: descending, ties to the lower expert (a
    stable sort; ``torch.topk`` does not promise an order among ties)."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


class Routes(NamedTuple):
    """One call's routing: ``dispatch`` (G, Tg, E, C) one-hot slots of
    the kept (token, expert) pairs (bool), ``gate`` (G, Tg, E) each
    selected expert's gate (zero elsewhere, differentiable), ``aux``
    the Switch load-balance loss, ``idx`` the choices (G, Tg, K),
    ``routed``/``kept`` the (token, choice) pairs before and after the
    capacity cut (int64 scalars on the device)."""

    dispatch: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor
    idx: torch.Tensor
    routed: torch.Tensor
    kept: torch.Tensor


def route(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
          tg: int) -> Routes:
    """The reference's routing of the groups ``xg`` (G, Tg, d): router
    logits in float32, top-k gates, GShard's priority (the K choices
    flattened ahead of the tokens before the running count, so a first
    choice is never dropped for a second one), capacity
    ``max(int(Tg·K/E·capacity_factor), 1)`` slots per expert and group,
    and the aux ``E·mean_G(Σ_e f_e·P_e)/K`` whose ``f_e`` counts the
    dropped pairs too."""
    E, K = cfg.n_experts, cfg.top_k
    G = xg.shape[0]
    cap = max(int(tg * K / E * cfg.capacity_factor), 1)
    logits = xg.float() @ router.float()
    gates, idx, probs = router_topk(logits, K)
    experts = torch.arange(E, device=xg.device)
    sel_k = idx[..., None] == experts  # (G, Tg, K, E)
    # position of each (choice, token) within its expert, choices first
    sel_kt = sel_k.transpose(1, 2).reshape(G, K * tg, E)
    pos = sel_kt.cumsum(1, dtype=torch.int32).reshape(G, K, tg, E) - 1
    pos = (pos.transpose(1, 2) * sel_k).sum(2)  # (G, Tg, E), the live choice
    sel = sel_k.any(2)
    keep = sel & (pos < cap)
    dispatch = (pos[..., None] == torch.arange(cap, device=xg.device)) \
        & keep[..., None]
    gate = (sel_k.to(f32) * gates[..., None]).sum(2)
    f_e = sel.to(f32).mean(1)  # (G, E) fraction routed (dropped included)
    p_e = probs.mean(1)
    aux = E * (f_e * p_e).sum(-1).mean() / K
    return Routes(dispatch, gate, aux, idx, sel.sum(), keep.sum())


def _experts(xe, w_gate, w_up, dtype):
    """The experts' gated hidden (G, E', C, f'): SiLU in float32 rounded
    to ``dtype``, times the up projection."""
    h_gate = torch.einsum("gecd,edf->gecf", xe, w_gate.to(dtype))
    h_up = torch.einsum("gecd,edf->gecf", xe, w_up.to(dtype))
    return F.silu(h_gate.float()).to(dtype) * h_up


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
            group_size: int = GROUP_SIZE, axis: shlib.ModelAxis | None = None,
            cut: str | None = None):
    """Grouped capacity-based MoE FFN → (out (b, s, d) in ``x``'s dtype,
    aux loss float32 scalar). ``p`` holds one layer's ``router`` (d, E),
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d), or under
    ``cut`` this rank's block of the experts: ``"experts"`` E/m whole
    experts (EP), ``"hidden"`` f/m columns of each (expert-TP), over
    ``axis``. Where the installed rule set cuts the batch over
    data-parallel ranks and a group of the global batch spans them,
    the group's rows are gathered over those ranks first (the module
    docstring)."""
    if cut not in (None, "experts", "hidden"):
        raise ValueError(f"cut {cut!r}; want None, 'experts' or 'hidden'")
    b, s, d = x.shape
    dtype = x.dtype
    t = b * s
    batch = shlib.batch_cut()
    tg = group_size_for(t * batch.ranks, group_size)
    spans = t % tg != 0
    xt = x.reshape(t, d)
    if spans:  # route the global batch
        xt = shlib.gather_rows(xt, batch)
    xg = xt.reshape(xt.shape[0] // tg, tg, d)
    with record_function("moe.route"):
        r = route(xg, p["router"], cfg, tg)
    _record(r)
    dispatch, gate = r.dispatch, r.gate
    lo = 0  # this rank's first row in the groups kept below
    if spans:  # keep the groups that hold this rank's rows
        lo = batch.index * t
        g0, g1 = lo // tg, (lo + t - 1) // tg + 1
        xg, dispatch, gate = (v.narrow(0, g0, g1 - g0)
                              for v in (xg, dispatch, gate))
        lo -= g0 * tg
    if cut is not None:
        xg = shlib.into_region(xg, axis)
        gate = shlib.into_region(gate, axis)
    if cut == "experts":
        n = p["w_gate"].shape[0]
        dispatch = dispatch.narrow(2, axis.index * n, n)
        gate = gate.narrow(2, axis.index * n, n)
    with record_function("moe.dispatch"):
        xe = torch.einsum("gtec,gtd->gecd", dispatch.to(dtype), xg)
    with record_function("moe.experts"):
        h = _experts(xe, p["w_gate"], p["w_up"], dtype)
        if cut == "hidden":  # this rank's rows of w_down: a partial sum
            ye = torch.einsum("gecf,efd->gecd", h.float(), p["w_down"].float())
        else:
            ye = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dtype))
    with record_function("moe.combine"):
        combine = (dispatch.to(f32) * gate[..., None]).to(dtype)
        if cut is None:
            y = torch.einsum("gtec,gecd->gtd", combine, ye)
        else:  # the ranks' partial sums added in float32, rounded once
            y = torch.einsum("gtec,gecd->gtd", combine.float(), ye.float())
            y = shlib.out_of_region(y, axis).to(dtype)
    y = y.reshape(-1, d).narrow(0, lo, t)
    return y.reshape(b, s, d), r.aux


# --- recording the routes (chip_smoke's drop shares and route flips) ----------


@contextlib.contextmanager
def recording(keep_routes: bool = False):
    """Inside, each :func:`moe_ffn` call adds its routed and kept
    (token, choice) pairs (of the whole global batch where its groups
    span data-parallel ranks, else of this rank's) to the yielded
    dict's ``routed``/``kept`` (device tensors, no host sync) and
    appends the pair of them to
    ``calls``; with ``keep_routes`` it appends its choices (G, Tg, K) to
    ``routes``."""
    prev = getattr(_STATE, "rec", None)
    rec = {"routed": 0, "kept": 0, "calls": [],
           "routes": [] if keep_routes else None}
    _STATE.rec = rec
    try:
        yield rec
    finally:
        _STATE.rec = prev


def _record(r: Routes) -> None:
    rec = getattr(_STATE, "rec", None)
    if rec is None:
        return
    rec["routed"] = rec["routed"] + r.routed
    rec["kept"] = rec["kept"] + r.kept
    rec["calls"].append((r.routed, r.kept))
    if rec["routes"] is not None:
        rec["routes"].append(r.idx.detach())
