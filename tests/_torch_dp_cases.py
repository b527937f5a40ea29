"""Rank functions of the port's data-parallel tests
(``tests/test_torch_dp_train.py``, ``tests/test_torch_distrib.py``,
``tests/test_torch_hybrid.py``),
run in processes spawned by ``repro_torch.launch.mesh.run_on_mesh`` on
CPU ranks over gloo.

This module imports torch and the port only (no JAX), so each spawned
rank starts light. Every rank builds the same full parameters from the
numpy tree it is given, takes its rows of each global batch and returns
numpy arrays (rank 0's results are the ones the tests read; every rank
checks what it can itself).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data import BatchIterator, MarkovLMDataset
from repro_torch.distrib import comm, grad_sync
from repro_torch.distrib import sharding as shlib
from repro_torch.launch import steps
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves_with_path

ARCH = "mamba2-780m"


def config(**kw):
    """The port's reduced mamba2 with ``kw`` (the tests' float32)."""
    return dataclasses.replace(reduced_config(get_config(ARCH)), **kw)


def flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(p): v.detach().double().numpy()
            for p, v in tree_leaves_with_path(tree)}


def _batch_rows(mesh, profile, data: dict, step: int):
    """This rank's rows of step ``step``'s global batch, from
    ``BatchIterator``, checked against the global batch cut by
    ``batch_spec``."""
    ds = MarkovLMDataset(data["vocab"], data["seq"], seed=data["seed"])
    axes = shlib.dp_axes(profile)
    it = BatchIterator(ds, data["batch"],
                       host_index=shlib.axis_index(mesh, axes),
                       host_count=shlib.axes_size(mesh, axes),
                       start_step=step)
    local = it.next_global("cpu")
    whole = {k: torch.from_numpy(v)
             for k, v in ds.batch(step, 0, data["batch"]).items()}
    for k, v in whole.items():
        cut = shlib.local_shard(v, shlib.batch_spec(k, v.shape, mesh, profile),
                                mesh)
        assert torch.equal(cut, local[k]), k
    return local


def train_rank(mesh, cases: dict, params_np, data: dict, opt_kw: dict):
    """Each case ``name: (profile, fsdp)``: the data-parallel step of the
    reduced mamba2 from ``params_np`` for ``data["steps"]`` steps: per
    step the loss, grad_norm and lr; step 0's synced gradient (gathered
    whole) from ``make_synced_grad_step``; the parameters and moments
    after the last step (gathered whole); the bytes this rank sent."""
    torch.set_num_threads(1)
    cfg = config()
    out = {}
    for name, (profile, fsdp) in cases.items():
        p_sh, o_sh = steps.train_shardings(cfg, mesh, profile=profile,
                                           fsdp=fsdp)
        full = convert.ssm_params_from_numpy(params_np, device="cpu")
        params = shlib.shard_tree(full, p_sh)
        opt = adamw_init(params)
        synced = steps.make_synced_grad_step(cfg, mesh=mesh, profile=profile,
                                             fsdp=fsdp, device="cpu")
        step_fn = steps.make_train_step(
            cfg, AdamWConfig(**opt_kw), device="cpu", mesh=mesh,
            profile=profile, fsdp=fsdp)
        rec = {"loss": [], "grad_norm": [], "lr": []}
        comm.reset_counts()
        for i in range(data["steps"]):
            batch = _batch_rows(mesh, profile, data, i)
            if i == 0:
                _, _, grads, _ = synced(params, batch)
                rec["grads0"] = flat(shlib.gather_tree(grads, p_sh))
                comm.reset_counts()
            params, opt, m = step_fn(params, opt, batch)
            for k in ("loss", "grad_norm", "lr"):
                rec[k].append(float(m[k]))
        rec["bytes"] = comm.counts["bytes"] / data["steps"]
        rec["params"] = flat(shlib.gather_tree(params, p_sh))
        rec["mu"] = flat(shlib.gather_tree(opt.mu, o_sh.mu))
        rec["shard_shapes"] = {k: v.shape for k, v in flat(params).items()}
        out[name] = rec
    return out


def save_rank(mesh, params_np, data: dict, opt_kw: dict, ckpt_dir: str,
              profile: str, fsdp: bool):
    """``data["steps"]`` steps, a sharded save of the state at step
    ``data["save_at"]`` (the manager's elastic save), then the rest: the
    losses of every step."""
    torch.set_num_threads(1)
    cfg = config()
    p_sh, o_sh = steps.train_shardings(cfg, mesh, profile=profile, fsdp=fsdp)
    params = shlib.shard_tree(
        convert.ssm_params_from_numpy(params_np, device="cpu"), p_sh)
    opt = adamw_init(params)
    step_fn = steps.make_train_step(cfg, AdamWConfig(**opt_kw), device="cpu",
                                    mesh=mesh, profile=profile, fsdp=fsdp)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    losses = []
    for i in range(data["steps"]):
        if i == data["save_at"]:
            mgr.save(i, {"params": params, "opt": opt},
                     shardings={"params": p_sh, "opt": o_sh})
        params, opt, m = step_fn(params, opt,
                                 _batch_rows(mesh, profile, data, i))
        losses.append(float(m["loss"]))
    return losses


def restore_rank(mesh, params_np, data: dict, opt_kw: dict, ckpt_dir: str,
                 profile: str, fsdp: bool):
    """Restore the latest checkpoint under this mesh's shardings and run
    to ``data["steps"]``: (the restored step, this rank's blocks equal
    to the stored leaves' cut, the losses from there)."""
    torch.set_num_threads(1)
    cfg = config()
    p_sh, o_sh = steps.train_shardings(cfg, mesh, profile=profile, fsdp=fsdp)
    params = shlib.shard_tree(
        convert.ssm_params_from_numpy(params_np, device="cpu"), p_sh)
    target = {"params": params, "opt": adamw_init(params)}
    shardings = {"params": p_sh, "opt": o_sh}
    mgr = CheckpointManager(ckpt_dir, keep=2)
    state, at = mgr.restore(target, shardings=shardings)
    whole, _ = mgr.restore(
        {"params": convert.ssm_params_from_numpy(params_np, device="cpu"),
         "opt": adamw_init(convert.ssm_params_from_numpy(params_np,
                                                         device="cpu"))})
    cut_ok = all(
        torch.equal(v, dict(tree_leaves_with_path(shardings))[p].shard(
            dict(tree_leaves_with_path(whole))[p]))
        for p, v in tree_leaves_with_path(state))
    step_fn = steps.make_train_step(cfg, AdamWConfig(**opt_kw), device="cpu",
                                    mesh=mesh, profile=profile, fsdp=fsdp)
    params, opt, losses = state["params"], state["opt"], []
    for i in range(at, data["steps"]):
        params, opt, m = step_fn(params, opt,
                                 _batch_rows(mesh, profile, data, i))
        losses.append(float(m["loss"]))
    return at, cut_ok, losses


def sync_rank(mesh, trees: list, fast: str, slow: str, ckpt_dir: str):
    """``grad_sync`` on this rank's tree ``trees[rank]`` (numpy leaves):
    hierarchical over (fast, slow), flat (one all-reduce over both),
    compressed over both (twice, the second with the first's residuals);
    each as numpy. Also :func:`mesh_rank`'s checks, and this rank's
    blocks of the checkpoint in ``ckpt_dir`` restored with ``a`` cut
    over (slow, fast) and ``nested/b`` whole."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    tree = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in trees[rank].items()}
    hier = grad_sync.hierarchical_psum_tree(tree, mesh, fast, slow)
    both = tuple(a for a in mesh.mesh_dim_names if a in (fast, slow))
    flat_sum = {k: v.clone() for k, v in tree.items()}
    comm.all_reduce_(list(flat_sum.values()), shlib.axis_group(mesh, both))
    comp, resid = grad_sync.compressed_psum_tree(tree, mesh, both)
    comp2, resid2 = grad_sync.compressed_psum_tree(tree, mesh, both,
                                                   error_feedback=resid)
    to_np = {k: {n: t.numpy() for n, t in v.items()}
             for k, v in dict(hier=hier, flat=flat_sum, comp=comp,
                              resid=resid, comp2=comp2,
                              resid2=resid2).items()}
    target = {"a": torch.zeros(4 // mesh.size(0), 8 // mesh.size(1)),
              "nested": {"b": torch.zeros(16, dtype=torch.int32)}}
    shardings = {"a": shlib.NamedSharding(mesh, (slow, fast)),
                 "nested": {"b": shlib.NamedSharding(mesh, ())}}
    restored, step = CheckpointManager(ckpt_dir).restore(
        target, shardings=shardings)
    blocks = (step, restored["a"].numpy(), restored["nested"]["b"].numpy())
    return to_np, mesh_rank(mesh), blocks


def mesh_rank(mesh):
    """On a group that is no production size: ``make_production_mesh``
    (single- and multi-pod) raises ValueError; the product group of
    every axis holds every rank, in rank order; ``axis_index`` is the
    rank's position in it."""
    from repro_torch.launch.mesh import make_production_mesh

    errors = []
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod, device="cpu")
        except ValueError as err:
            errors.append(str(err))
    names = mesh.mesh_dim_names
    group = shlib.axis_group(mesh, names)
    ranks = torch.distributed.get_process_group_ranks(group)
    return errors, ranks, shlib.axis_index(mesh, names)


def hybrid_rank(mesh, params_np, data: dict, opt_kw: dict):
    """One data-parallel step (the tp profile, a model axis of one) of
    the reduced recurrentgemma-9b from ``params_np`` through the generic
    ``make_train_step(mesh=)``: the loss, grad_norm, step 0's synced
    gradient and the parameters after the step (gathered whole)."""
    torch.set_num_threads(1)
    cfg = reduced_config(get_config("recurrentgemma-9b"))
    p_sh, _ = steps.train_shardings(cfg, mesh)
    params = shlib.shard_tree(
        convert.model_params_from_numpy(params_np, device="cpu"), p_sh)
    batch = _batch_rows(mesh, "tp", data, 0)
    _, _, grads, _ = steps.make_synced_grad_step(cfg, mesh=mesh,
                                                 device="cpu")(params, batch)
    step_fn = steps.make_train_step(cfg, AdamWConfig(**opt_kw), device="cpu",
                                    mesh=mesh)
    params, _, m = step_fn(params, adamw_init(params), batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads0": flat(shlib.gather_tree(grads, p_sh)),
            "params": flat(shlib.gather_tree(params, p_sh))}
