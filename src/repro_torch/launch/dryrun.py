"""Multi-pod dry run (the eager counterpart of ``repro.launch.dryrun``).

For every (architecture × input shape) cell that ``cell_status`` lets
run, on the single-pod (16×16 = 256 ranks) and multi-pod (2×16×16 = 512
ranks) production layouts, with nothing allocated (every tensor on the
``meta`` device) and no card:

(a) rank 0's blocks of the parameters, of AdamW's state (train), of the
    batch and of the decode cache (decode), cut by the ``tp`` profile's
    rules (``param_spec``, ``batch_spec``, the cache rules): their bytes
    are the rank's resident bytes, the counterpart of XLA's
    ``memory_analysis().argument_size_in_bytes``, beside the card's 80 GB;
(b) one step of the cell, rank 0's program, under
    ``torch.utils.flop_counter.FlopCounterMode``: the counterpart of
    ``lower`` + ``compile`` + ``cost_analysis()["flops"]``. A full-size
    step that fails here is a port bug, as a failed lowering is in the
    reference;
(c) the reference's record fields where they mean the same thing:
    FLOPs, the modeled memory bytes (``core.trafficmodel``), the
    collective calls and wire bytes, the three roofline terms on the
    H100's data-sheet rates (``core.rooflinelib``), the dominant one,
    the model FLOPs (6·N·D, 2·N a token) and their shares.

How rank 0's program runs: the process joins a process group of 256
(512) ranks on PyTorch's ``fake`` backend (``torch.testing``'s
``FakeStore``), whose collectives return at once and move nothing, and
builds the production ``DeviceMesh`` on it. The step makers then run as
on a real mesh: the tensor-parallel regions, the MoE's gathers, the
gradient sync and every other collective go through ``distrib.comm``
(its ``fake`` route), which counts each call and the bytes this rank
would send by the ring model, the reference's ``parse_collectives``.
What this leaves out: the values (a collective moves nothing, so the
program's data-dependent choices are those of meta tensors, which have
none in these models) and any rank but 0 (the ranks' programs differ
only in which block they hold).

Layer extrapolation, as the reference's ``extrapolated_metrics``:
``FlopCounterMode`` sees every ATen call of the eager step, every layer
and remat's recomputation included, so a full-depth step gives the
count directly (``full_depth=True``, ``--full-depth``). But a meta
tensor's elementwise ops run PyTorch's Python reference kernels, about
0.1-7 ms a call (a ``torch.where`` on a (2, 16, 1024, 1024) block takes
~7 ms), and a 32k-token prefill makes ~25,000 of them a layer in its
1024 x 1024 attention blocks: ~12 s of host time a layer, hours for the
sweep. The layers of a family are identical, so by default each cell
runs at two shallow depths (1 and 2 layers; whisper 1 and 2 of each
stack; the hybrid 3 and 6, and 7 for its tail) at full width and
batch, and the FLOPs, collective calls and bytes are extrapolated
linearly to the full depth, as the reference does for another reason
(XLA counts a ``while`` body once). The resident bytes are the full
depth's, built on meta without running anything.
``tests/test_torch_dryrun.py`` holds the extrapolation to the full-depth
count at reduced configs.

Left out, having no eager meaning: the HLO byte count
(``hbm_bytes_hlo_per_chip``, ``memory_s_hlo_upper``), the collectives'
result bytes (``comm`` counts the wire bytes), compile times and the
generated code size. B7, a ``ctypes`` launch, is not seen by the
counter on the card; on meta mamba2 takes the plain conv, whose
elementwise multiply-adds the counter does not count either.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k --mesh both --out results/dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 4
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any

import torch

from repro_torch.configs.registry import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    cell_status,
    get_config,
    get_model,
    uses_fsdp,
)
from repro_torch.core import rooflinelib as rl
from repro_torch.core.trafficmodel import modeled_hbm_bytes
from repro_torch.distrib import comm
from repro_torch.distrib import sharding as shlib
from repro_torch.launch import specs as S
from repro_torch.launch import steps
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.tree import tree_leaves


@contextlib.contextmanager
def fake_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a process group
    of the ``fake`` backend (this process is rank 0), destroyed on
    exit.

    Raises:
        RuntimeError: when a process group is already initialized.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a group")
    world = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield DeviceMesh("cpu", torch.arange(world).reshape(tuple(shape)),
                         mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _inputs(cfg: ModelConfig, shape: ShapeSpec, device, seed: int | None):
    """The cell's global inputs on ``device``: meta stand-ins
    (``launch.specs``) or, with ``seed``, seeded values of their shapes
    (token ids below the vocab, normal floats; the VLM's M-RoPE
    positions those of a 4 x 4 patch grid, as the tests draw them)."""
    specs = {"train": S.train_input_specs, "prefill": S.prefill_input_specs,
             "decode": S.decode_input_specs}[shape.kind](cfg, shape)
    if seed is None:
        return specs
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in specs.items():
        if k == "positions":
            t = torch.arange(v.shape[-1]).expand(v.shape[1:])
            out[k] = torch.stack([t, t // 4, t % 4])
        elif v.dtype == S.INDEX:
            out[k] = torch.randint(0, cfg.vocab, v.shape, generator=gen)
        else:
            out[k] = torch.randn(v.shape, generator=gen).to(v.dtype)
    return {k: v.to(device) for k, v in out.items()}


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh=None, *,
               fsdp: bool = False, device="meta", seed: int | None = None):
    """One step of ``shape``'s kind for ``cfg`` on this rank of ``mesh``
    (None: one rank): (``run``, a callable that runs the step once,
    and this rank's resident bytes: parameter blocks, AdamW's state
    (train), batch rows and cache block (decode)). On ``device="meta"``
    every tensor is a stand-in; elsewhere the parameters come from
    ``init_params(cfg, seed)`` and the inputs from ``seed``."""
    api = get_model(cfg)
    if seed is None:
        full = S.abstract_params(cfg)
    else:
        full = api.init_params(cfg, seed=seed, device=device)
    batch = _inputs(cfg, shape, device, seed)
    rows = shape.global_batch
    fsdp = fsdp and shape.kind == "train"  # serving holds the tp blocks
    if mesh is not None:
        p_sh, _ = steps.train_shardings(cfg, mesh, fsdp=fsdp)
        params = shlib.shard_tree(full, p_sh)
        batch = {k: shlib.local_shard(
            v, shlib.batch_spec(k, tuple(v.shape), mesh), mesh).contiguous()
            for k, v in batch.items()}
    else:
        params = full
    resident = tree_bytes(params) + tree_bytes(batch)
    kw = dict(mesh=mesh, device=device)
    if mesh is not None:
        kw["batch_rows"] = rows
    if shape.kind == "train":
        opt = S.abstract_opt_state(params)
        resident += tree_bytes(opt)
        # donated, as a trainer runs it: the update lands in place
        step = steps.make_train_step(cfg, AdamWConfig(), fsdp=fsdp,
                                     donate=True, **kw)
        return (lambda: step(params, opt, batch)), resident
    if shape.kind == "prefill":
        step = steps.make_prefill_step(cfg, **kw)
        return _serving(lambda: step(params, batch)), resident
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(shlib.rules_context(mesh, batch_rows=rows))
        if cfg.is_encdec:
            from repro_torch.models import encdec

            frames = torch.zeros((batch["tokens"].shape[0], cfg.encoder_seq,
                                  cfg.d_model), dtype=torch.bfloat16,
                                 device=device)
            cache = encdec.init_decode_cache(params, cfg, frames)
        else:
            cache = api.init_decode_cache(cfg, rows, shape.seq_len,
                                          device=device)
    resident += tree_bytes(cache)
    step = steps.make_serve_step(cfg, **kw)
    return _serving(lambda: step(params, cache, batch)), resident


def _serving(run):
    """``run`` without autograd, as a server runs its steps."""
    def no_grad_run():
        with torch.no_grad():
            return run()
    return no_grad_run


def count_flops(run) -> tuple[float, dict]:
    """(FLOPs ``FlopCounterMode`` counts in ``run()``, the collectives
    ``distrib.comm`` counted in it)."""
    from torch.utils.flop_counter import FlopCounterMode

    comm.reset_counts()
    with FlopCounterMode(display=False) as fc:
        run()
    return float(fc.get_total_flops()), dict(comm.counts)


def tokens_per_step(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """The tokens one step of ``shape`` processes (the reference's
    ``lower_cell`` count): whisper's target length in training, its
    encoder frames at prefill; one new token a row at decode."""
    if shape.kind == "train":
        return shape.global_batch * (cfg.max_target_len if cfg.is_encdec
                                     else shape.seq_len)
    if shape.kind == "prefill":
        return shape.global_batch * (cfg.encoder_seq if cfg.is_encdec
                                     else shape.seq_len)
    return shape.global_batch


def _lin(a: dict, b: dict, sa: float, sb: float) -> dict:
    """sa·a + sb·b key by key (counts rounded, never below 0)."""
    keys = set(a) | set(b)
    return {k: max(round(sa * a.get(k, 0) + sb * b.get(k, 0), 6), 0)
            for k in keys}


def extrapolated_counts(cfg: ModelConfig, measure) -> dict:
    """The full depth's counts from ``measure(cfg_at_depth)`` (a dict of
    ``flops`` and ``distrib.comm`` counts) at shallow depths: the
    reference's layer-delta method (``repro.launch.dryrun:117``)."""
    import dataclasses as dc

    if cfg.is_encdec:
        a = measure(dc.replace(cfg, n_layers=1, n_encoder_layers=1))
        b = measure(dc.replace(cfg, n_layers=2, n_encoder_layers=2))
        return _lin(a, _lin(b, a, 1.0, -1.0), 1.0, float(cfg.n_layers - 1))
    if cfg.hybrid_pattern:
        n_super = cfg.n_layers // cfg.hybrid_pattern
        n_tail = cfg.n_layers - n_super * cfg.hybrid_pattern
        a = measure(dc.replace(cfg, n_layers=3))
        b = measure(dc.replace(cfg, n_layers=6))
        total = _lin(a, _lin(b, a, 1.0, -1.0), 1.0, float(n_super - 1))
        if n_tail:
            c = measure(dc.replace(cfg, n_layers=7))
            total = _lin(total, _lin(c, b, 1.0, -1.0), 1.0, float(n_tail))
        return total
    a = measure(dc.replace(cfg, n_layers=1))
    b = measure(dc.replace(cfg, n_layers=2))
    return _lin(a, _lin(b, a, 1.0, -1.0), 1.0, float(cfg.n_layers - 1))


def analyze_cell(arch_id: str, shape_name: str, mesh, *,
                 cfg_override: ModelConfig | None = None,
                 full_depth: bool = False) -> dict:
    """The record of one cell on ``mesh`` (a ``DeviceMesh``, normally
    :func:`fake_mesh`'s production layout): the step's counts at full
    depth (``full_depth``) or extrapolated from two shallow depths
    (:func:`extrapolated_counts`)."""
    cfg = cfg_override or get_config(arch_id)
    shape = SHAPES[shape_name]
    sizes = shlib.mesh_axis_sizes(mesh)
    chips = math.prod(sizes.values())
    fsdp = uses_fsdp(arch_id)
    t0 = time.perf_counter()

    def measure(c):
        run, _ = build_cell(c, shape, mesh, fsdp=fsdp)
        flops, coll = count_flops(run)
        return dict(coll, flops=flops)

    counts = (measure(cfg) if full_depth
              else extrapolated_counts(cfg, measure))
    _, resident = build_cell(cfg, shape, mesh, fsdp=fsdp)
    step_s = time.perf_counter() - t0
    flops = float(counts.pop("flops"))
    stats = rl.collective_stats(counts)
    modeled = modeled_hbm_bytes(
        cfg, shape.kind, shape.seq_len, shape.global_batch,
        model_ways=sizes.get("model", 1),
        dp_ways=sizes.get("pod", 1) * sizes.get("data", 1), fsdp=fsdp)
    roof = rl.Roofline(flops=flops, hbm_bytes=modeled,
                       collective_wire_bytes=float(stats.total_wire_bytes),
                       chips=chips, hw=rl.H100_SXM5, dtype_bytes=2)
    n_params, n_active = cfg.n_params(), cfg.n_active_params()
    toks = tokens_per_step(cfg, shape)
    model = (rl.model_flops_train if shape.kind == "train"
             else rl.model_flops_decode)(n_active, toks) / chips
    return {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": "multi" if "pod" in sizes else "single",
        "chips": chips,
        "kind": shape.kind,
        "status": "ok",
        "depth": "full" if full_depth else "extrapolated",
        "analysis_s": round(step_s, 2),
        "flops_per_chip": roof.flops,
        "hbm_bytes_modeled_per_chip": roof.hbm_bytes,
        "coll_wire_bytes": roof.collective_wire_bytes,
        "coll_counts": stats.counts,
        "compute_s": roof.compute_s,
        "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "dominant": roof.dominant,
        "bound_s": roof.bound_s,
        "model_flops_per_chip": model,
        "useful_flops_ratio": roof.useful_flops_fraction(model),
        "roofline_fraction": roof.roofline_fraction(model),
        "resident_bytes_per_chip": resident,
        "resident_share_of_hbm": resident / rl.H100_SXM5.hbm_bytes,
        "n_params": n_params,
        "n_active_params": n_active,
    }


def _cell_job(arch_id, shape_name, multi_pod, full_depth):
    """One cell in a worker process of its own (its own fake group)."""
    torch.set_num_threads(1)
    status = cell_status(arch_id, shape_name)
    mesh_name = "multi" if multi_pod else "single"
    if status != "run":
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": status}
    try:
        with fake_mesh(*PRODUCTION_MESHES[multi_pod]) as mesh:
            return analyze_cell(arch_id, shape_name, mesh,
                                full_depth=full_depth)
    except Exception as e:  # noqa: BLE001
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def _describe(rec: dict) -> str:
    head = f"{rec['arch']} × {rec['shape']} × {rec['mesh']}"
    if rec["status"] == "ok":
        return (f"[cell] {head}: ok in {rec['analysis_s']} s dominant="
                f"{rec['dominant']} compute={rec['compute_s']:.3e}s memory="
                f"{rec['memory_s']:.3e}s coll={rec['collective_s']:.3e}s "
                f"resident={rec['resident_bytes_per_chip'] / 1e9:.2f} GB")
    if rec["status"] == "FAIL":
        return f"[cell] {head}: FAIL {rec['error']}"
    return f"[skip] {head}: {rec['status']}"


def run_cells(cells, multi: str, out_path: str | None, *, jobs: int = 1,
              full_depth: bool = False, log=print) -> list[dict]:
    """Every cell of ``cells`` on the meshes of ``multi`` (``single``,
    ``multi`` or ``both``), ``jobs`` worker processes at a time (each
    cell in a process of its own, its own fake group): a record each,
    written to ``out_path`` as they come (cells already there are
    skipped)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    results: list[dict[str, Any]] = []
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[multi]
    todo = [(a, s, mp) for mp in meshes for a, s in cells
            if (a, s, "multi" if mp else "single") not in done]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max(1, jobs), mp_context=ctx) as pool:
        futures = [pool.submit(_cell_job, a, s, mp, full_depth)
                   for a, s, mp in todo]
        for fut in futures:
            rec = fut.result()
            log(_describe(rec))
            results.append(rec)
            if out_path:
                os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
    return results


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=min(4, os.cpu_count() or 1),
                    help="cells analysed at once, a process each")
    ap.add_argument("--full-depth", action="store_true",
                    help="run every layer instead of extrapolating from "
                         "two shallow depths (slow: hours for --all)")
    args = ap.parse_args(argv)

    if args.all:
        # shape-major: the roofline-critical training cells first
        cells = [(a, s) for s in SHAPES for a in ARCH_IDS]
    else:
        archs = [args.arch] if args.arch else list(ARCH_IDS)
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]
    results = run_cells(cells, args.mesh, args.out, jobs=args.jobs,
                        full_depth=args.full_depth)
    ok = sum(1 for r in results if r.get("status") == "ok")
    fail = sum(1 for r in results if r.get("status") == "FAIL")
    skip = len(results) - ok - fail
    print(f"\ndry-run: {ok} ok, {skip} skipped (documented), {fail} FAILED")
    if fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
