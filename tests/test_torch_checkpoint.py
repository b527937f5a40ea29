"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``) against
the reference's (``repro.checkpoint``): the same layout, so a checkpoint
written by either package restores in the other, bit for bit; keep-k
retention; no step visible before its rename; restore onto the target's
device and the saved dtype.

The tree is a train state as both trainers save it: ``{"params": the
reduced mamba2's parameters, "opt": AdamW's OptState (step, mu, nu)}``
after a few updates, so every leaf holds distinct values.
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.configs import registry as jreg
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as tmanager
from repro_torch.optim import OptState
from repro_torch.tree import tree_leaves_with_path


@pytest.fixture(autouse=True)
def _f32_reference_and_two_threads():
    """The reference in JAX's default float32, whatever another test file
    set (several turn on ``jax_enable_x64`` for the whole process), and
    torch on two threads (the test workers share the CPU, and small ops
    spread over every core stall under that load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with jax.enable_x64(False):
            yield
    finally:
        torch.set_num_threads(threads)


def _states():
    """(JAX train state, the same state as port tensors on the CPU)."""
    cfg = dataclasses.replace(jreg.reduced_config(
        jreg.get_config("mamba2-780m")), n_layers=2)
    params = jssm.init_params(cfg, jax.random.PRNGKey(0))
    opt = jadamw.adamw_init(params)
    key = jax.random.PRNGKey(1)
    for _ in range(2):
        key, sub = jax.random.split(key)
        leaves, treedef = jax.tree.flatten(params)
        grads = treedef.unflatten([
            jax.random.normal(jax.random.fold_in(sub, i), v.shape)
            for i, v in enumerate(leaves)])
        params, opt, _ = jadamw.adamw_update(jadamw.AdamWConfig(), grads,
                                             opt, params)
    jstate = {"params": params, "opt": opt}
    npstate = jax.tree.map(np.asarray, jstate)
    tstate = {"params": convert.ssm_params_from_numpy(npstate["params"],
                                                      device="cpu"),
              "opt": convert.opt_state_from_numpy(npstate["opt"],
                                                  device="cpu")}
    return jstate, tstate


def _np_leaves(tree) -> dict[str, np.ndarray]:
    if isinstance(jax.tree_util.tree_leaves(tree)[0], jax.Array):
        return {jmanager._path_str(p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {"/".join(p): v.numpy() for p, v in tree_leaves_with_path(tree)}


def _assert_bit_equal(got, want):
    g, w = _np_leaves(got), _np_leaves(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert g[k].shape == w[k].shape, k
        assert g[k].tobytes() == w[k].tobytes(), k


def _zeros_like(tstate):
    return {"params": jax.tree.map(torch.zeros_like, tstate["params"]),
            "opt": OptState(torch.zeros((), dtype=torch.int32),
                            jax.tree.map(torch.zeros_like, tstate["opt"].mu),
                            jax.tree.map(torch.zeros_like, tstate["opt"].nu))}


def test_both_packages_write_the_same_layout(tmp_path):
    jstate, tstate = _states()
    jm = jmanager.CheckpointManager(str(tmp_path / "jax"))
    tm = CheckpointManager(str(tmp_path / "torch"))
    jm.save(7, jstate, blocking=True)
    tm.save(7, tstate, blocking=True)
    for m in (jm, tm):
        assert m.all_steps() == [7] and m.latest_step() == 7
    dirs = [tmp_path / d / "step_00000007" for d in ("jax", "torch")]
    manifests = [json.loads((d / "manifest.json").read_text())
                 for d in dirs]
    for m in manifests:
        m.pop("treedef")
    assert manifests[0] == manifests[1]
    paths = {e["path"] for e in manifests[1]["leaves"]}
    assert {"opt/step", "opt/mu/blocks/in_proj", "params/embed",
            "opt/nu/final_norm"} <= paths
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    assert "opt_mu_blocks_in_proj.npy" in os.listdir(dirs[1])


def test_a_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    jstate, tstate = _states()
    jmanager.CheckpointManager(str(tmp_path)).save(4, jstate, blocking=True)
    restored, step = CheckpointManager(str(tmp_path)).restore(
        _zeros_like(tstate))
    assert step == 4
    assert isinstance(restored["opt"], OptState)
    assert restored["opt"].step.dtype == torch.int32
    assert int(restored["opt"].step) == 2
    _assert_bit_equal(restored, jstate)


def test_a_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    jstate, tstate = _states()
    CheckpointManager(str(tmp_path)).save(9, tstate, blocking=True)
    target = jax.tree.map(jnp.zeros_like, jstate)
    restored, step = jmanager.CheckpointManager(str(tmp_path)).restore(target)
    assert step == 9
    _assert_bit_equal(restored, tstate)
    again, _ = CheckpointManager(str(tmp_path)).restore(_zeros_like(tstate))
    _assert_bit_equal(again, tstate)


def test_keep_k_and_overwrite(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "n": {"b": torch.ones(4)}}
    for step in (10, 20, 30):
        mgr.save(step, tree)  # asynchronous; the next save waits
    mgr.wait()
    assert mgr.all_steps() == [20, 30]
    tree["a"] += 1  # the snapshot was taken at save time
    mgr.save(30, tree, blocking=True)
    restored, step = mgr.restore(tree)
    assert step == 30 and torch.equal(restored["a"], tree["a"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000020", "step_00000030"]


def test_save_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.zeros(5)
    mgr.save(1, {"x": x})
    x += 7  # the caller overwrites its buffer right away
    mgr.wait()
    assert torch.equal(mgr.restore({"x": x}, 1)[0]["x"], torch.zeros(5))


def test_no_step_is_visible_before_its_rename(tmp_path, monkeypatch):
    """The writer thread fills ``step_*.tmp-*``; until it renames, the
    step is not listed, and the latest step is the previous one."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(3)}, blocking=True)
    entered, release = threading.Event(), threading.Event()
    real_save = np.save

    def slow_save(path, arr):
        entered.set()
        assert release.wait(30)
        real_save(path, arr)

    monkeypatch.setattr(tmanager.np, "save", slow_save)
    mgr.save(2, {"x": torch.full((3,), 2.0)})
    try:
        assert entered.wait(30)
        names = sorted(os.listdir(tmp_path))
        assert names[0] == "step_00000001"
        assert len(names) == 2 and names[1].startswith("step_00000002.tmp-")
        assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    finally:
        release.set()
        mgr.wait()
    assert mgr.all_steps() == [1, 2]
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000002"]


def test_restore_places_leaves_and_checks_them(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(2)})
    mgr.save(3, {"x": torch.arange(4, dtype=torch.float64),
                 "i": torch.tensor(5, dtype=torch.int32)}, blocking=True)
    target = {"x": torch.zeros(4, device="meta"), "i": torch.zeros(())}
    restored, _ = mgr.restore(target)
    assert restored["x"].device.type == "meta"
    assert restored["x"].dtype == torch.float64  # the saved dtype
    assert restored["i"].dtype == torch.int32 and int(restored["i"]) == 5
    with pytest.raises(ValueError, match="shape mismatch for x"):
        mgr.restore({"x": torch.zeros(5), "i": torch.zeros(())})
    with pytest.raises(KeyError, match="missing leaf y"):
        mgr.restore({"y": torch.zeros(4)})
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(4, {"x": torch.zeros(2, dtype=torch.bfloat16)})
