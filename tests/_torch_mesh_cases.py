"""Rank functions of the port's sharded tests (``tests/test_torch_halo.py``,
``tests/test_torch_sharded.py``), run in processes spawned by
``repro_torch.launch.mesh.run_on_mesh`` on CPU ranks over gloo.

This module imports torch and the port only (no JAX), so each spawned
rank starts light. Every rank rebuilds the same global fields from numpy
seeds, runs its cases and saves its block of each result as
``<case>.<what>.<rank>.npy`` in the directory it is given; the tests
read the blocks back, join them with ``launch.mesh.assemble_blocks`` and
hold them against the JAX package.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from repro_torch import as_dtype


def field(shape, dtype: str, seed: int):
    """The global field of a case as numpy (bfloat16 values rounded to
    bfloat16 and carried in float32, so both packages cast exactly)."""
    a = np.random.default_rng(seed).standard_normal(shape)
    if dtype == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16).float().numpy()
    return a.astype(dtype)


def to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(as_dtype(dtype))


def save(out_dir, case: str, what: str, rank: int, t: torch.Tensor) -> None:
    if t.dtype == torch.bfloat16:
        t = t.float()  # exact
    np.save(Path(out_dir) / f"{case}.{what}.{rank}.npy", t.detach().numpy())


def load_blocks(out_dir, case: str, what: str, world: int) -> list:
    return [torch.from_numpy(np.load(Path(out_dir) / f"{case}.{what}.{r}.npy"))
            for r in range(world)]


def halo_rank(mesh, cases: dict, out_dir: str) -> dict:
    """Each case ``name: (mesh_axes, shape, radii, dtype, axis_1d)``:
    ``exchange_halos_nd`` of this rank's block, and ``exchange_halo_1d``
    along spatial axis ``axis_1d`` (None: not run)."""
    from repro_torch.core import halo
    from repro_torch.launch.mesh import local_block

    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    halo.reset_counts()
    for name, (mesh_axes, shape, radii, dtype, axis_1d) in cases.items():
        g = to_torch(field(shape, dtype, seed=len(name)), dtype)
        fl = local_block(g, mesh, mesh_axes).contiguous()
        fp = halo.exchange_halos_nd(
            fl, radii, mesh_axes, spatial_axes=range(1, g.ndim), mesh=mesh)
        save(out_dir, name, "nd", rank, fp)
        if axis_1d is not None:
            f1 = halo.exchange_halo_1d(
                fl, radii[axis_1d], mesh, mesh_axes[axis_1d],
                axis=1 + axis_1d)
            save(out_dir, name, "1d", rank, f1)
    return dict(halo.counts)


def _op(case: dict):
    from repro_torch.core.fusion import FusedStencilOp
    from repro_torch.core.stencil import derivative_operator_set

    ops = derivative_operator_set(3, 6, spacing=0.3)
    return FusedStencilOp(
        ops, stencil_phi(case["phi"], case["strategy"]), case["n_out"],
        strategy=case["strategy"], fuse_steps=case["depth"], device="cpu",
    )


def stencil_phi(kind: str, strategy: str):
    """The φ of a stencil case: ``tests/test_distrib.py``'s own φ in
    PyTorch on ``hwc``; on the CUDA strategies, whose kernels compile φ
    in, the ``select`` DevicePhi of ``dxx``."""
    from repro_torch.kernels.phi import select_phi

    if strategy != "hwc" or kind == "select":
        return select_phi("dxx")
    if kind == "mix":
        def phi(d):
            return torch.stack([
                d["val"][0] + 0.1 * (d["dxx"] + d["dyy"] + d["dzz"])[0],
                d["dx"][1] * d["dy"][0] + d["dxy"][1],
            ])
        return phi
    if kind == "pair":
        def phi(d):
            return torch.stack([
                d["val"][0] + 0.1 * (d["dxx"] + d["dyy"] + d["dzz"])[0],
                d["val"][1] + 0.05 * d["dx"][1] * d["dy"][0],
            ])
        return phi
    # "carry": the aux-carrying pair of per-step maps
    def mk(c):
        def phi(d, a):
            f_new = d["val"] + c * d["dxx"] + 0.1 * a * d["dyy"][:1]
            w_new = 0.5 * a + c * d["val"][:1]
            return torch.cat([f_new, w_new])
        return phi
    return (mk(0.3), mk(0.7))


def stencil_rank(mesh, cases: dict, out_dir: str) -> dict:
    """Each case ``name: dict(strategy, phi, n_out, depth, seed, shape,
    mesh_axes, aux_shape, overlaps)``: ``apply_sharded`` of this rank's
    block at each overlap setting; reports per case the overlap paths
    taken or the ValueError raised."""
    from repro_torch.core import fusion
    from repro_torch.launch.mesh import local_block

    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    report = {}
    for name, case in cases.items():
        op = _op(case)
        rng = np.random.default_rng(case["seed"])
        f = torch.from_numpy(
            rng.standard_normal(case["shape"]).astype(np.float32))
        aux = None
        if case["aux_shape"] is not None:
            aux = local_block(torch.from_numpy(
                rng.standard_normal(case["aux_shape"]).astype(np.float32)),
                mesh, case["mesh_axes"])
        fl = local_block(f, mesh, case["mesh_axes"])
        paths = []
        try:
            for overlap in case["overlaps"]:
                fusion.reset_sharded_counts()
                out = op.apply_sharded(
                    fl, case["mesh_axes"], aux, overlap=overlap, mesh=mesh)
                paths.append(dict(fusion.sharded_counts))
                save(out_dir, name, f"overlap{int(overlap)}", rank, out)
        except ValueError as err:
            report[name] = ("ValueError", str(err))
            continue
        report[name] = ("ok", paths)
    return report


def mhd_rank(mesh, cases: dict, out_dir: str) -> dict:
    """Each case ``name: dict(strategy, form, shape, mesh_axes,
    overlap)``: the MHD RHS op (``form="rhs"``) or the ``fuse_rk_pairs``
    pair op with a zero carry (``form="pair"``) on this rank's block."""
    from repro_torch.core import fusion
    from repro_torch.launch.mesh import local_block
    from repro_torch.physics.mhd import MHDSolver

    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    report = {}
    for name, case in cases.items():
        solver = MHDSolver(case["shape"], strategy=case["strategy"],
                           device="cpu")
        f = local_block(solver.init_fields(seed=3), mesh, case["mesh_axes"])
        fusion.reset_sharded_counts()
        if case["form"] == "rhs":
            out = solver.rhs_op().apply_sharded(
                f, case["mesh_axes"], overlap=case["overlap"], mesh=mesh)
        else:
            out = solver._fused_pair_op(1e-3).apply_sharded(
                f, case["mesh_axes"], torch.zeros_like(f),
                overlap=case["overlap"], mesh=mesh)
        report[name] = dict(fusion.sharded_counts)
        save(out_dir, name, "out", rank, out)
    return report


def auto_rank(mesh, shape, mesh_axes, cache_dir: str, out_dir: str) -> dict:
    """``strategy="auto"`` through ``apply_sharded``: the tuner's search
    counted on each rank; returns the plan this rank ran."""
    from repro_torch.core.fusion import FusedStencilOp
    from repro_torch.core.stencil import derivative_operator_set
    from repro_torch.kernels.phi import select_phi
    from repro_torch.launch.mesh import local_block
    from repro_torch.tuning import session

    os.environ["REPRO_TORCH_TUNE_CACHE"] = cache_dir
    torch.set_num_threads(1)
    searches = []
    search = session.auto_strategy_nd

    def counted(*args, **kwargs):
        searches.append(1)
        return search(*args, **kwargs)

    session.auto_strategy_nd = counted
    op = FusedStencilOp(derivative_operator_set(3, 4, spacing=0.3),
                        select_phi("dxx"), 2, strategy="auto", device="cpu")
    f = torch.from_numpy(
        np.random.default_rng(21).standard_normal(shape).astype(np.float32))
    fl = local_block(f, mesh, mesh_axes)
    out = op.apply_sharded(fl, mesh_axes, mesh=mesh)
    again = op.apply_sharded(fl, mesh_axes, mesh=mesh)
    rank = torch.distributed.get_rank()
    save(out_dir, "auto", "out", rank, out)
    concrete = op._resolved[next(iter(op._resolved))]
    return dict(
        searches=len(searches), equal_again=bool(torch.equal(out, again)),
        plan=(concrete.strategy, tuple(concrete.block),
              int(concrete.fuse_steps)),
    )


def mhd_and_auto_rank(mesh, mhd: dict, auto_shape, auto_axes, cache_dir: str,
                      out_dir: str):
    """:func:`mhd_rank`, then :func:`auto_rank`, in one spawn."""
    return (mhd_rank(mesh, mhd, out_dir),
            auto_rank(mesh, auto_shape, auto_axes, cache_dir, out_dir))
