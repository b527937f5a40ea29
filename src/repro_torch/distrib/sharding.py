"""Sharding rules: parameter specs, batch specs and their placement on a
process mesh (port of ``repro.distrib.sharding``; the tables are copies:
the port imports nothing of ``repro``).

Mesh contract (``launch/mesh.py``): dimensions ``("pod", "data",
"model")`` multi-pod or ``("data", "model")`` single-pod. Parallelism
mapping, as in the reference:

* **DP**    — batch over ``(pod, data)`` (all three under the ``dp``
              profile); gradients summed over those ranks
              (``grad_sync``).
* **TP**    — attention heads / FFN hidden / vocab over ``model``: the
              ``tp`` profile's rules below, as explicit Megatron tensor
              parallelism for every family: the dense, MoE and VLM
              transformers (``models/transformer.py``; the MoE's
              experts over ``model``, EP, or their hidden width,
              expert-TP, in ``models/moe.py``), mamba2
              (``models/ssm.py``), the hybrid (``models/hybrid.py``)
              and whisper (``models/encdec.py``): the model code reads
              the installed rule set (:func:`model_axis`,
              :func:`leaf_held`, :func:`cache_spec`) and calls the
              region operators (:func:`into_region`,
              :func:`out_of_region`, :func:`gather_for_compute`,
              :func:`region_slice`, :func:`row_parallel`). Each family
              takes the cuts the reference's rules make as they match
              its leaves, and no others.
              The MoE's groups are GSPMD's over the global batch: where
              one spans data-parallel ranks the FFN gathers its rows
              over them (:func:`batch_cut`, :func:`gather_rows`).
* **FSDP**  — parameters (and their AdamW moments) additionally cut over
              the data-parallel ranks, ZeRO-style (``fsdp=True``).

A spec is a plain tuple with one entry per dim: None, an axis name, or a
tuple of axis names (their product), with trailing Nones stripped as
``PartitionSpec`` strips them. Rules are *divisibility-safe*: a dim is
only cut if the named axes' product divides it, as in the reference.

:class:`NamedSharding` pairs a spec with a
:class:`~torch.distributed.device_mesh.DeviceMesh`: which dims are cut
over which mesh dimensions (:meth:`NamedSharding.cuts`) and this rank's
slice of a full tensor (:func:`local_shard`). :func:`axis_group` is the
process group of a mesh axis or of a tuple of axes (their product).

``set_rules``, ``rules_context`` and ``constrain`` keep the reference's
activation-annotation hook. ``constrain`` annotates for GSPMD's
partitioner, and eager PyTorch has none: the collectives that GSPMD
derives from the annotations are explicit here (the region operators),
so it stays the identity, as the reference's is without an installed
rule set.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
from typing import Any, Mapping

import torch

from repro_torch.distrib import comm
from repro_torch.tree import path_str, tree_leaves_with_path, tree_map_with_path

_STATE = threading.local()

# Activation rules: logical name -> tuple of (axis names or None) per dim,
# or a LIST of such tuples (candidates tried in order; first one whose every
# requested axis divides wins — e.g. EP vs expert-TP for MoE tensors).
DEFAULT_ACT_RULES: dict[str, tuple | list] = {
    "tokens_bs": (("pod", "data"), None),
    # Megatron-style TP baseline: the residual stream is replicated over
    # `model` between blocks (one all-reduce after attention + one after
    # MLP). Sequence parallelism (seq over `model`, rule below) trades
    # those all-reduces for all-gather/reduce-scatter pairs + sharded
    # norms — evaluated as a §Perf iteration, not the baseline.
    "act_bsd": (("pod", "data"), None, None),
    "act_bsd_sp": (("pod", "data"), "model", None),  # sequence-parallel
    "act_bshd": (("pod", "data"), None, "model", None),  # heads TP
    "logits_bsv": (("pod", "data"), None, "model"),  # vocab TP
    "decode_bd": (("pod", "data"), None),
    # unembedding weight AFTER dtype cast: the convert breaks GSPMD's
    # propagation from the parameter sharding, and an unconstrained
    # (d, V) operand lets the partitioner pick a d-sharded dot with a
    # full-vocab f32 all-reduce (40 GiB at qwen vocab; §Perf cell 2).
    "unembed_dv": (None, "model"),
    # decode KV cache (b, L, g, dh): head TP, else sequence-sharded
    "cache_blgd": [
        (("pod", "data"), None, "model", None),
        (("pod", "data"), "model", None, None),
    ],
    "moe_gecd": [
        (("pod", "data"), "model", None, None),  # EP: experts sharded
        (("pod", "data"), None, None, None),
    ],
    "moe_gecf": [
        (("pod", "data"), "model", None, None),  # EP
        (("pod", "data"), None, None, "model"),  # expert-TP (E < mesh)
    ],
}


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a mapping of names to
    sizes (the rules need no process group)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def _axes_size(axes, sizes: Mapping[str, int]) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes.get(axes, 1)
    return math.prod(sizes.get(a, 1) for a in axes)


def _filter_axes(axes, sizes):
    """Drop axes missing from the mesh (e.g. 'pod' on single-pod)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in sizes else None
    kept = tuple(a for a in axes if a in sizes)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def _spec_dims(shape, wanted, sizes) -> tuple[list, bool]:
    """Per-dim axes after divisibility filtering + whether every
    *requested* (mesh-present) axis survived."""
    dims, complete = [], True
    for dim, axes in zip(shape, wanted):
        axes = _filter_axes(axes, sizes)
        n = _axes_size(axes, sizes)
        if n > 1 and dim % n == 0:
            dims.append(axes)
        else:
            dims.append(None)
            if axes is not None:
                complete = False
    return dims, complete


def safe_spec(shape: tuple[int, ...], wanted: tuple | list, mesh) -> tuple:
    """A spec from desired per-dim axes, dropping any assignment whose
    axis product does not divide the dim size. ``wanted`` may be a list
    of candidates — the first fully-satisfiable one wins."""
    sizes = mesh_axis_sizes(mesh)
    candidates = wanted if isinstance(wanted, list) else [wanted]
    chosen = None
    for cand in candidates:
        dims, complete = _spec_dims(shape, cand, sizes)
        if chosen is None:
            chosen = dims
        if complete:
            chosen = dims
            break
    dims = chosen or []
    while dims and dims[-1] is None:
        dims.pop()
    return tuple(dims)


# --- parameter sharding ------------------------------------------------------

# path regex -> wanted axes per dim (leading layer-stack dim always None).
# FSDP adds ("data",) to the first matching non-TP dim (see param_spec).
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("model", None)),  # vocab-parallel embedding
    (r"unembed$", (None, "model")),
    (r"blocks/(wq|wk|wv)$", (None, None, "model")),
    (r"blocks/(bq|bk|bv)$", (None, "model")),
    (r"blocks/wo$", (None, "model", None)),
    (r"blocks/(w_gate|w_up)$", (None, None, "model")),
    (r"blocks/w_down$", (None, "model", None)),
    (r"blocks/moe/router$", (None, None, None)),
    # experts over model (EP) when E ≥ mesh; else expert-TP on d_ff.
    (r"blocks/moe/(w_gate|w_up)$", [
        (None, "model", None, None),
        (None, None, None, "model"),
    ]),
    (r"blocks/moe/w_down$", [
        (None, "model", None, None),
        (None, None, "model", None),
    ]),
    # recurrentgemma RG-LRU block
    (r"blocks_rec/(w_x|w_gate_in)$", (None, None, "model")),
    (r"blocks_rec/w_out$", (None, "model", None)),
    (r"blocks_rec/(w_a_gate|w_i_gate|a_param|conv_w|conv_b|gate_bias)", (None, "model")),
    (r"blocks_rec/(w_g|w_u)$", (None, None, "model")),
    (r"blocks_rec/w_d$", (None, "model", None)),
    # mamba2
    (r"blocks/in_proj$", (None, None, "model")),
    (r"blocks/out_proj$", (None, "model", None)),
    (r"blocks/(conv_w|conv_b|ssm_norm)$", (None, "model")),
    (r"blocks/(A_log|D|dt_bias)$", (None, "model")),
    # whisper encoder/decoder extra mats
    (r"(enc_blocks|blocks)/(wq_x|wk_x|wv_x)$", (None, None, "model")),
    (r"(enc_blocks|blocks)/wo_x$", (None, "model", None)),
    (r"(enc_blocks|blocks)/(w_in)$", (None, None, "model")),
    (r"(enc_blocks|blocks)/(w_out)$", (None, "model", None)),
]

_FSDP_ELIGIBLE = re.compile(
    r"(wq|wk|wv|wo|w_gate|w_up|w_down|in_proj|out_proj|w_in|w_out|embed|unembed)$"
)


def _pick_candidate(shape, wanted, sizes) -> tuple:
    if isinstance(wanted, list):
        for cand in wanted:
            _, complete = _spec_dims(shape, cand, sizes)
            if complete:
                return cand
        return wanted[0]
    return wanted


def param_spec(
    path: str, shape: tuple[int, ...], mesh, *, fsdp: bool = False,
    profile: str = "tp",
) -> tuple:
    """The spec of the parameter at ``path`` (keys joined by "/") of
    ``shape`` on ``mesh`` (a ``DeviceMesh`` or {axis name: size})."""
    if profile == "dp":
        if fsdp:  # ZeRO over the whole device set
            n = math.prod(mesh_axis_sizes(mesh).values())
            for i, dim in enumerate(shape):
                if dim % n == 0 and dim > 1:
                    wanted = [None] * len(shape)
                    wanted[i] = ("pod", "data", "model")
                    return safe_spec(shape, tuple(wanted), mesh)
        return ()
    wanted: tuple | list | None = None
    for pat, rule in PARAM_RULES:
        if re.search(pat, path):
            wanted = rule
            break
    if wanted is None:
        wanted = (None,) * len(shape)
    wanted = _pick_candidate(shape, wanted, mesh_axis_sizes(mesh))
    wanted = tuple(wanted[: len(shape)]) + (None,) * (len(shape) - len(wanted))
    if fsdp and _FSDP_ELIGIBLE.search(path):
        # Shard the largest still-unsharded dim over data (ZeRO-3 style).
        sizes = mesh_axis_sizes(mesh)
        n = sizes.get("data", 1)
        best, best_dim = None, 0
        for i, (dim, axes) in enumerate(zip(shape, wanted)):
            if axes is None and dim % n == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is not None:
            wanted = tuple(
                "data" if i == best else a for i, a in enumerate(wanted)
            )
    return safe_spec(shape, wanted, mesh)


def param_shardings(params_shape: Any, mesh, *, fsdp: bool = False,
                    profile: str = "tp") -> Any:
    """The tree of :class:`NamedSharding` on ``mesh`` (a ``DeviceMesh``)
    matching a tree of (possibly meta) tensors."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(
            path_str(path), tuple(leaf.shape), mesh, fsdp=fsdp,
            profile=profile)),
        params_shape)


def dp_axes(profile: str = "tp") -> tuple[str, ...]:
    """The mesh axes the batch is cut over: ``(pod, data)``, or every
    axis under the pure-DP profile."""
    if profile not in PROFILES:
        raise ValueError(f"profile {profile!r}; want one of {sorted(PROFILES)}")
    return ("pod", "data", "model") if profile == "dp" else ("pod", "data")


def batch_spec(name: str, shape: tuple[int, ...], mesh,
               profile: str = "tp") -> tuple:
    """A batch entry's spec (the reference's ``batch_shardings`` rule,
    ``repro.launch.steps:22``): leading batch over the DP axes;
    ``positions`` (3, b, s) carries batch on dim 1."""
    dp = dp_axes(profile)
    if name == "positions":
        wanted = (None, dp, None)
    else:
        wanted = (dp,) + (None,) * (len(shape) - 1)
    return safe_spec(tuple(shape), wanted, mesh)


# --- placement on a DeviceMesh ---------------------------------------------------


def _axes_tuple(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class Cut:
    """Dim ``dim`` of a tensor cut into ``parts`` equal blocks over the
    mesh axes ``axes``; this rank holds block ``index``."""

    dim: int
    axes: tuple[str, ...]
    parts: int
    index: int


def axis_group(mesh, axes):
    """The process group of this rank over the mesh axes ``axes`` (a name
    or a tuple of names, in the mesh's order): the dimension's group
    for one name, the group over their product (ranks ordered as the
    axes' coordinates, row-major) for several. Axes missing from the
    mesh are dropped; None when no axis is left."""
    names = list(mesh.mesh_dim_names)
    axes = tuple(a for a in _axes_tuple(axes) if a in names)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} are not in the mesh's order {names}")
    # Built once per mesh (a collective: every rank of the mesh makes
    # every group, in one order) and kept on the mesh.
    groups = mesh.__dict__.setdefault("_product_groups", {})
    if axes not in groups:
        ranks = mesh.mesh.movedim(dims, list(range(len(dims))))
        ranks = ranks.reshape(math.prod(ranks.shape[:len(dims)]), -1).t()
        groups[axes], _ = torch.distributed.new_subgroups_by_enumeration(
            [[int(r) for r in row] for row in ranks])
    return groups[axes]


def axis_index(mesh, axes) -> int:
    """This rank's position along the product of the mesh axes ``axes``
    (row-major in their order); 0 when none is in the mesh."""
    sizes = mesh_axis_sizes(mesh)
    index = 0
    for a in _axes_tuple(axes):
        if a in sizes:
            index = index * sizes[a] + mesh.get_local_rank(a)
    return index


def axes_size(mesh, axes) -> int:
    """Ranks along the product of the mesh axes ``axes``."""
    return _axes_size(_axes_tuple(axes), mesh_axis_sizes(mesh))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec placed on a ``DeviceMesh`` (the reference's
    ``jax.sharding.NamedSharding``). A frozen dataclass, not a tuple, so
    that a tree of them has them as leaves."""

    mesh: Any
    spec: tuple

    def cuts(self) -> list[Cut]:
        """The dims the spec cuts, with their axes, parts and this
        rank's block."""
        return [Cut(d, _axes_tuple(a), axes_size(self.mesh, a),
                    axis_index(self.mesh, a))
                for d, a in enumerate(self.spec) if a is not None]

    @property
    def replicated(self) -> bool:
        return not any(a is not None for a in self.spec)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a view)."""
        return local_shard(full, self.spec, self.mesh)

    def gather(self, shard: torch.Tensor, axes=None) -> torch.Tensor:
        """The full tensor from every rank's ``shard`` (a collective: each
        rank of the cut axes' groups calls it); with ``axes`` (a tuple of
        mesh axis names) only the cuts over those axes are gathered."""
        full = shard
        for cut in reversed(self.cuts()):
            if axes is not None and not set(cut.axes) <= set(axes):
                continue
            group = axis_group(self.mesh, cut.axes)
            moved = full.movedim(cut.dim, 0).contiguous()
            full = comm.all_gather(moved, group).movedim(0, cut.dim)
        return full.contiguous()


def local_shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` on the
    ``DeviceMesh`` ``mesh``: each cut dim narrowed to its block (a
    view)."""
    if len(spec) > t.ndim:
        raise ValueError(f"spec {spec} has more entries than {tuple(t.shape)}")
    for cut in NamedSharding(mesh, tuple(spec)).cuts():
        extent = t.shape[cut.dim]
        if extent % cut.parts:
            raise ValueError(
                f"dim {cut.dim} of {tuple(t.shape)} does not split into "
                f"{cut.parts} equal blocks over {cut.axes}")
        width = extent // cut.parts
        t = t.narrow(cut.dim, cut.index * width, width)
    return t


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` (full tensors) cut to this rank's block, as a
    contiguous copy where it is cut (so the full tensor can be freed).
    A KV cache (a tuple with an empty ``slots``) gets its block's
    :func:`kv_slots`, as ``init_decode_cache`` under the rule set does."""
    by_path = dict(tree_leaves_with_path(shardings))

    def one(path, leaf):
        sh = by_path[path]
        return leaf if sh.replicated else sh.shard(leaf).contiguous()

    out = tree_map_with_path(one, tree)
    if getattr(out, "slots", False) is None:
        out = out._replace(slots=kv_slots(shardings.k, out.k.shape[2],
                                          out.k.device))
    return out


def gather_tree(tree: Any, shardings: Any, axes=None) -> Any:
    """Each leaf of ``tree`` (this rank's blocks) gathered to its full
    shape (a collective); with ``axes``, only its cuts over those mesh
    axes (the tensor-parallel step gathers the ZeRO cuts and keeps the
    ``model`` blocks)."""
    by_path = dict(tree_leaves_with_path(shardings))

    def one(path, leaf):
        sh = by_path[path]
        return leaf if sh.replicated else sh.gather(leaf, axes)

    return tree_map_with_path(one, tree)


# --- activation constraints --------------------------------------------------


# Pure data-parallel profile: the `model` axis joins the batch axes and
# parameters replicate. Right for models whose per-chip matmuls are too
# small to amortize TP collectives (mamba2-780m: d=1536 → Megatron ARs
# dominate; §Perf cell 3). Gradient sync cost moves to the optimizer
# all-reduce, which overlaps with backward.
_DPM = ("pod", "data", "model")
DP_ACT_RULES: dict[str, tuple | list] = {
    "tokens_bs": (_DPM, None),
    "act_bsd": (_DPM, None, None),
    "act_bshd": (_DPM, None, None, None),
    "logits_bsv": (_DPM, None, None),
    "decode_bd": (_DPM, None),
    "cache_blgd": (_DPM, None, None, None),
    "unembed_dv": (None, None),
    "moe_gecd": (_DPM, None, None, None),
    "moe_gecf": (_DPM, None, None, None),
}

PROFILES = {"tp": DEFAULT_ACT_RULES, "dp": DP_ACT_RULES}


def profile_act_rules(profile: str):
    return PROFILES[profile]


def set_rules(mesh, rules: Mapping[str, tuple] | None = None, *,
              batch_rows: int | None = None):
    """Install ``rules`` (the ``tp`` profile's by default) on ``mesh`` (a
    ``DeviceMesh`` or {axis name: size}). ``batch_rows``, where the
    caller knows it, is the global batch's row count, from which
    :func:`batch_cut` reads the axes ``batch_spec`` really cuts the
    batch over."""
    _STATE.mesh = mesh
    _STATE.rules = dict(rules or DEFAULT_ACT_RULES)
    _STATE.batch_rows = batch_rows


@contextlib.contextmanager
def rules_context(mesh, rules: Mapping[str, tuple] | None = None, *,
                  batch_rows: int | None = None):
    prev = (getattr(_STATE, "mesh", None), getattr(_STATE, "rules", None),
            getattr(_STATE, "batch_rows", None))
    set_rules(mesh, rules, batch_rows=batch_rows)
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules, _STATE.batch_rows = prev


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The reference's activation annotation. It asks GSPMD's
    partitioner to lay ``x`` out by the installed rule for ``kind`` and
    to insert the collectives that layout needs; eager PyTorch has no
    partitioner, and the port's model code makes those collectives
    itself (the region operators below), so ``x`` comes back as it is,
    with or without a rule set."""
    del kind
    return x


# --- tensor parallelism: the tp profile's model axis ---------------------------


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The installed mesh's ``model`` axis as the model code uses it:
    its process group, its ranks and this rank's position."""

    mesh: Any
    group: Any
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class BatchCut:
    """The mesh axes that really cut the batch the model sees (``()``
    where every rank holds it whole), their ranks, this rank's position
    along their product and their process group (None under a mapping
    of sizes or where nothing is cut)."""

    axes: tuple[str, ...]
    ranks: int
    index: int
    group: Any


def batch_cut() -> BatchCut:
    """How the installed rule set cuts the batch: over the ``tokens_bs``
    rule's batch axes (``(pod, data)``, every axis under the ``dp``
    profile) as ``batch_spec`` cuts it, which is not at all where their
    ranks do not divide its rows.

    The model sees this rank's rows, not the global batch, so the rows
    come from the caller (``batch_rows`` of :func:`rules_context`; the
    step makers pass theirs on). Without them a ``DeviceMesh``'s ranks
    hold their rows of a batch cut over those axes (as
    ``BatchIterator`` and ``batch_spec`` cut every batch whose rows the
    ranks divide), and under a mapping of sizes, where no rank holds
    other rows, the model holds every row and nothing is cut."""
    mesh = getattr(_STATE, "mesh", None)
    rules = getattr(_STATE, "rules", None)
    rows = getattr(_STATE, "batch_rows", None)
    if mesh is None or not rules or (rows is None
                                     and isinstance(mesh, Mapping)):
        return BatchCut((), 1, 0, None)
    sizes = mesh_axis_sizes(mesh)
    wanted = rules["tokens_bs"][0]
    if rows is not None:
        spec = safe_spec((int(rows),), (wanted,), mesh)
        wanted = spec[0] if spec else None
    axes = tuple(a for a in _axes_tuple(_filter_axes(wanted, sizes))
                 if sizes[a] > 1)
    ranks = _axes_size(axes, sizes)
    if ranks == 1 or isinstance(mesh, Mapping):
        return BatchCut(axes, ranks, 0, None)
    return BatchCut(axes, ranks, axis_index(mesh, axes),
                    axis_group(mesh, axes))


def batch_ranks() -> int:
    """The ranks that really cut the batch (:func:`batch_cut`); 1
    without a rule set."""
    return batch_cut().ranks


def gather_rows(x: torch.Tensor, cut: BatchCut) -> torch.Tensor:
    """Every rank's rows ``x`` (dim 0) of the batch cut by ``cut``,
    stacked in the global batch's order (an all-gather over its
    group); the gradient summed over those ranks and cut back to this
    rank's rows (a reduce-scatter).

    Raises:
        ValueError: under a mapping of axis sizes, which has no ranks
            to gather from.
    """
    if cut.ranks == 1:
        return x
    if cut.group is None:
        raise ValueError(
            f"the batch is cut over {cut.axes} ({cut.ranks} ranks) on a "
            "mapping of axis sizes, which has no process group to gather "
            "its rows over")
    return _GatherForCompute.apply(x, cut.group, 0)


def model_axis() -> ModelAxis | None:
    """The ``model`` axis of the installed rule set (``set_rules`` /
    ``rules_context``) when it cuts attention heads over more than one
    rank (the ``tp`` profile on a ``DeviceMesh``); else None, and the
    model runs as on one card (no rule set, a mapping of sizes, a model
    axis of 1, or the ``dp`` profile, where ``model`` joins the batch
    axes)."""
    mesh = getattr(_STATE, "mesh", None)
    rules = getattr(_STATE, "rules", None)
    if mesh is None or isinstance(mesh, Mapping) or not rules:
        return None
    size = mesh_axis_sizes(mesh).get("model", 1)
    heads = rules.get("act_bshd", ())
    if size == 1 or len(heads) < 3 or "model" not in _axes_tuple(heads[2]):
        return None
    cached = mesh.__dict__.get("_model_axis")
    if cached is None:
        cached = ModelAxis(mesh, axis_group(mesh, "model"), size,
                           mesh.get_local_rank("model"))
        mesh.__dict__["_model_axis"] = cached
    return cached


@dataclasses.dataclass(frozen=True)
class LeafCut:
    """How the tp profile lays a parameter over ``model``: ``dim`` is the
    dim cut over it (None: whole on every rank) and ``on_units`` whether
    each block holds whole units (heads of ``unit`` columns)."""

    dim: int | None
    on_units: bool


def leaf_cut(path: str, shape: tuple[int, ...], unit: int = 1) -> LeafCut:
    """The installed mesh's tp cut of the parameter at ``path`` (its full
    ``shape``) over ``model``: ``param_spec``'s (the reference's
    ``PARAM_RULES`` through ``safe_spec``), whatever ``fsdp`` adds over
    ``data``."""
    mesh = getattr(_STATE, "mesh", None)
    size = mesh_axis_sizes(mesh).get("model", 1)
    for d, axes in enumerate(param_spec(path, shape, mesh, profile="tp")):
        if "model" in _axes_tuple(axes):
            return LeafCut(d, (shape[d] // size) % unit == 0)
    return LeafCut(None, True)


def leaf_held(path: str, shape: tuple[int, ...], unit: int = 1
              ) -> tuple[str, int | None]:
    """How this rank holds the parameter at ``path`` (its full
    ``shape``) under the installed mesh's tp cut (:func:`leaf_cut`):
    ``("cut", dim)``, its block of whole units of ``unit``;
    ``("gather", dim)``, a block that splits a unit (joined whole for
    the computation); or ``("whole", None)``."""
    cut = leaf_cut(path, shape, unit)
    if cut.dim is None:
        return "whole", None
    return ("cut" if cut.on_units else "gather"), cut.dim


# The decode caches' rules (the reference's ``cache_shardings``,
# ``repro.launch.steps:47``): wanted axes per dim, behind the layer
# axis; a list holds candidates, the first one whose every axis divides
# wins. ``kv``: a transformer's KV cache (b, L, g, dh), KV heads over
# ``model``, else the sequence; ``heads``: the hybrid's KV ring and
# whisper's self and cross K/V, by heads only; ``channels``: a conv
# window (b, k-1, c) by channels (mamba2's xBC, the hybrid's width);
# ``width``: the hybrid's RG-LRU state (b, w); ``ssm_state``: mamba2's
# (b, h, n, p) by heads.
_DP = ("pod", "data")
CACHE_RULES: dict[str, tuple | list] = {
    "kv": [(None, _DP, None, "model", None), (None, _DP, "model", None, None)],
    "heads": (None, _DP, None, "model", None),
    "channels": (None, _DP, None, "model"),
    "width": (None, _DP, "model"),
    "ssm_state": (None, _DP, "model", None, None),
}


def cache_spec(rule: str, shape: tuple[int, ...], mesh) -> tuple:
    """The spec of a stacked decode-cache leaf of ``shape`` (layer axis
    first) under :data:`CACHE_RULES`' ``rule``. As in the reference, a
    candidate counts only where every axis it names is above one rank
    and divides its dim, so on a mesh whose data axis is 1 a KV cache
    is cut by heads or not at all."""
    return safe_spec(shape, CACHE_RULES[rule], mesh)


def kv_cache_spec(shape: tuple[int, ...], mesh) -> tuple:
    """The spec of a stacked KV cache leaf ``(n_layers, b, L, g, dh)``:
    KV heads over ``model``, else the sequence (:func:`cache_spec`'s
    ``kv`` rule, the tp profile's ``cache_blgd`` candidates behind the
    layer axis)."""
    return cache_spec("kv", shape, mesh)


def kv_slots(sharding: NamedSharding, width: int,
             device) -> torch.Tensor | None:
    """The global positions of the ``width`` slots of a stacked KV cache
    block ``(n_layers, b, width, g, dh)`` whose leaves ``sharding`` cuts;
    None where it does not cut the sequence (the block holds every
    slot)."""
    for cut in sharding.cuts():
        if cut.dim == 2 and cut.parts > 1:
            return torch.arange(width, device=device) + cut.index * width
    return None


def cache_block(rule: str, shape: tuple[int, ...]) -> tuple[int, ...]:
    """This rank's block shape of a ``shape`` cache leaf (layer axis,
    then the global batch) under ``rule`` on the installed mesh: where
    :func:`model_axis` is set, :func:`cache_spec`'s block; else the
    batch cut as :func:`batch_cut` cuts the tokens, the rest whole (the
    model then runs on its rows as on one card); ``shape`` itself
    without a rule set.

    Raises:
        ValueError: where the ranks that cut the batch do not divide
            the cache's rows.
    """
    axis = model_axis()
    if axis is not None:
        return block_shape(shape, cache_spec(rule, shape, axis.mesh),
                           axis.mesh)
    ranks = batch_cut().ranks
    if shape[1] % ranks:
        raise ValueError(f"a cache of {shape[1]} rows does not split over "
                         f"the {ranks} ranks that cut the batch")
    return (shape[0], shape[1] // ranks) + tuple(shape[2:])


def block_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """The shape of this rank's block of a ``shape`` tensor under
    ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // _axes_size(_axes_tuple(a), sizes)
                 for n, a in zip(shape, spec))


class _IntoRegion(torch.autograd.Function):
    """Identity forward; the gradient summed over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        comm.all_reduce_([grad], ctx.group)
        return grad, None


class _OutOfRegion(torch.autograd.Function):
    """The ranks' partial sums added over ``model`` forward; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        comm.all_reduce_([x], group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherForCompute(torch.autograd.Function):
    """The ranks' blocks joined along ``dim`` forward (all-gather); the
    full gradient's sum over ``model`` cut back to this rank's block
    backward (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        moved = x.movedim(dim, 0).contiguous()
        return comm.all_gather(moved, group).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        moved = grad.movedim(ctx.dim, 0).contiguous()
        out = comm.reduce_scatter(moved, ctx.group).movedim(0, ctx.dim)
        return out, None, None


def into_region(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Megatron's *f*: ``x`` (whole on every rank) enters a region where
    each rank computes a part; its gradient, partial on each rank, is
    all-reduced over ``model``."""
    return _IntoRegion.apply(x, axis.group)


def out_of_region(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Megatron's *g*: the ranks' partial ``x`` summed over ``model`` (an
    all-reduce in ``x``'s dtype); the gradient passes as it is."""
    return _OutOfRegion.apply(x, axis.group)


def gather_for_compute(x: torch.Tensor, axis: ModelAxis, dim: int
                       ) -> torch.Tensor:
    """``x``, this rank's block of a tensor cut along ``dim`` over
    ``model``, joined whole for the computation (all-gather); its
    gradient reduce-scattered back into the block."""
    return _GatherForCompute.apply(x, axis.group, dim % x.dim())


def region_whole(w: torch.Tensor, axis: ModelAxis, held: str, dim: int
                 ) -> torch.Tensor:
    """A parameter used by each rank for its own part inside a region,
    whole: gathered along ``dim`` where this rank holds a block (``held``
    ``"cut"`` or ``"gather"``; its gradient reduce-scattered back), else
    entered by :func:`into_region` (its gradient, partial on each rank,
    summed over ``model``)."""
    if held == "whole":
        return into_region(w, axis)
    return gather_for_compute(w, axis, dim)


def region_slice(w: torch.Tensor, axis: ModelAxis, held: str, dim: int,
                 lo: int, n: int) -> torch.Tensor:
    """``[lo, lo + n)`` along ``dim`` (global positions) of a parameter
    used inside a region: from this rank's block where ``held`` is
    ``"cut"`` (the block of equal parts holds the range), else from
    :func:`region_whole`."""
    if held == "cut":
        lo -= axis.index * w.shape[dim]
    else:
        w = region_whole(w, axis, held, dim)
    return w.narrow(dim, lo, n)


def row_parallel(x: torch.Tensor, w: torch.Tensor, axis: ModelAxis
                 ) -> torch.Tensor:
    """``x @ w`` where ``w`` is this rank's block of rows and ``x`` their
    columns: each rank's partial product with a float32 result, summed
    over ``model`` in float32 and rounded once to ``x``'s dtype, as one
    card's product rounds its float32 accumulator once (bf16 partial
    sums, each rounded before the sum, drift over the layers)."""
    return out_of_region(x.float() @ w.float(), axis).to(x.dtype)


def model_sum(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The ranks' partial ``x`` summed over ``model`` where every rank
    goes on with the sum for its own part: all-reduced forward and
    backward (:func:`out_of_region` after :func:`into_region`), as a
    norm's sum of squares over a cut width is."""
    return out_of_region(into_region(x, axis), axis)


def model_max(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The elementwise max of every rank's ``x`` over ``model`` (no
    gradient: a softmax's shift)."""
    rows = comm.all_gather(x.detach().reshape(1, -1).contiguous(),
                           axis.group)
    return rows.amax(0).view_as(x)
