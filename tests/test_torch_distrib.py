"""The port's distribution layer for training (``repro_torch.distrib``:
``sharding``, ``grad_sync``, ``comm``; ``launch.mesh``'s production mesh
and ``parse_mesh``; the elastic checkpoint; the train CLI over a mesh)
against the JAX package's (``repro.distrib``).

* ``param_spec`` equals the reference's for every leaf of all ten
  reference configs' abstract parameter trees, on meshes (2, 4), (16,
  16) and (2, 16, 16), under ``tp`` and ``dp``, with and without fsdp
  (the reference gets a stand-in mesh with ``axis_names`` and
  ``devices.shape``, all its rules read). The rule tables are copies.
* ``grad_sync`` against the reference's under ``shard_map`` on 8 host
  devices, as ``tests/test_distrib.py:223-278`` runs it, on mesh (2, 4)
  of ``("pod", "data")``: each rank holds 3 rows (not a multiple of the
  fast group of 4); ``hierarchical_psum`` against the flat sum and the
  reference within 1e-5; ``compressed_psum_tree``'s residuals equal the
  reference's bit for bit and its sums within 2e-2 (bf16 on the wire),
  with and without error feedback; ``accumulate_grads`` on the
  reference test's linear loss and on the reduced mamba2 within 1e-5.
* The elastic checkpoint: a ZeRO state saved on (2, 1) restores on (4,
  1) and on one process to blocks equal to the stored leaves' cuts, and
  the continued losses equal the uninterrupted run's within 1e-5 (the
  continuation sums each batch over other ranks, so float32 rounds
  otherwise).
* The train CLI over ``--mesh 2x1 --backend gloo`` on CPU ranks with a
  failure injected: the same losses as ``--mesh 1x1`` to the printed
  digits, one restart, its last checkpoint continuing on one process;
  ``--backend nccl`` without a card per rank and a ``model`` axis above
  1 raise.

The port's ranks are CPU processes over gloo (``run_on_mesh``, spawned
in the background while this process runs the reference).
"""
import dataclasses
import os
import re
import subprocess
import sys
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import _torch_dp_cases as cases  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.distrib import grad_sync as jgs  # noqa: E402
from repro.distrib import sharding as jshlib  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import MarkovLMDataset  # noqa: E402
from repro_torch.distrib import grad_sync, sharding as shlib  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import path_str, tree_leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPEC_MESHES = {(2, 4): ("data", "model"), (16, 16): ("data", "model"),
               (2, 16, 16): ("pod", "data", "model")}
SYNC_MESH = ((2, 4), ("pod", "data"))
ROWS = 3  # rows a rank holds: not a multiple of the fast group (4)
DATA = dict(vocab=512, seq=32, batch=4, seed=5, steps=4, save_at=2)
OPT = dict(lr_peak=3e-3, warmup_steps=1, total_steps=4)
CLI = ["--reduced", "--device", "cpu", "--steps", "6", "--global-batch",
       "2", "--seq-len", "32", "--ckpt-every", "2",
       "--simulate-failure-at", "3", "--log-every", "1"]


@pytest.fixture(autouse=True)
def _f32_reference():
    """The reference in JAX's default float32, whatever another test file
    set for the process."""
    with jax.enable_x64(False):
        yield


def _shard_map(fn, mesh, in_specs, out_specs):
    if hasattr(jax, "shard_map"):
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    from jax.experimental.shard_map import shard_map

    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_rep=False)


def _sync_inputs():
    """The global (24, 16) and (8, 5) gradients; rank r's tree is their
    r-th block of rows (``P(("pod", "data"))``)."""
    rng = np.random.default_rng(11)
    n = int(np.prod(SYNC_MESH[0]))
    w = rng.standard_normal((n * ROWS, 16)).astype(np.float32)
    v = (rng.standard_normal((n, 5)) * 1e-3).astype(np.float32)
    trees = [{"w": w[r * ROWS:(r + 1) * ROWS], "v": v[r:r + 1]}
             for r in range(n)]
    return w, v, trees


def _model_params():
    jcfg = dataclasses.replace(
        jreg.reduced_config(jreg.get_config(cases.ARCH)), dtype="float32")
    return jcfg, jssm.init_params(jcfg, jax.random.PRNGKey(4))


def _run_cli(mesh: str, ckpt: Path, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI, "--mesh",
         mesh, "--backend", "gloo", "--ckpt-dir", str(ckpt), *extra],
        capture_output=True, text=True, env=env, timeout=300)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank job of the module, started at once in the background:
    the (2, 4) sync mesh; the (2, 1) ZeRO save, then its (4, 1) restore;
    the train CLI on 1x1 and 2x1. This process meanwhile runs the
    reference's tests."""
    tmp = tmp_path_factory.mktemp("distrib")
    mgr = CheckpointManager(str(tmp / "tree"), keep=2)
    tree = {"a": torch.arange(32, dtype=torch.float32).reshape(4, 8),
            "nested": {"b": torch.ones(16, dtype=torch.int32)}}
    for step in (10, 20, 30):
        mgr.save(step, tree, blocking=True)
    _, _, trees = _sync_inputs()
    with jax.enable_x64(False):
        params_np = jax.tree.map(np.asarray, _model_params()[1])
    ckpt = str(tmp / "zero")

    def save_then_restore():
        saved = tmesh.run_on_mesh(
            cases.save_rank, (2, 1), ("data", "model"), backend="gloo",
            device="cpu", args=(params_np, DATA, OPT, ckpt, "dp", True),
            timeout=300)
        restored = tmesh.run_on_mesh(
            cases.restore_rank, (4, 1), ("data", "model"), backend="gloo",
            device="cpu", args=(params_np, DATA, OPT, ckpt, "dp", True),
            timeout=300)
        return saved, restored

    pool = ThreadPoolExecutor(4)
    jobs = {
        "sync": pool.submit(tmesh.run_on_mesh, cases.sync_rank, *SYNC_MESH,
                            backend="gloo", device="cpu",
                            args=(trees, "data", "pod", str(tmp / "tree")),
                            timeout=300),
        "elastic": pool.submit(save_then_restore),
        "cli1": pool.submit(_run_cli, "1x1", tmp / "cli1"),
        "cli2": pool.submit(_run_cli, "2x1", tmp / "cli2"),
    }
    yield jobs, params_np, ckpt
    pool.shutdown(wait=True)


def _result(spawned, name):
    return spawned[0][name].result()


# --- sharding rules -----------------------------------------------------------------


def test_rule_tables_are_the_references():
    assert shlib.DEFAULT_ACT_RULES == jshlib.DEFAULT_ACT_RULES
    assert shlib.PARAM_RULES == jshlib.PARAM_RULES
    assert shlib.DP_ACT_RULES == jshlib.DP_ACT_RULES
    assert shlib._FSDP_ELIGIBLE.pattern == jshlib._FSDP_ELIGIBLE.pattern
    assert set(shlib.PROFILES) == set(jshlib.PROFILES)
    for k in shlib.PROFILES:
        assert shlib.profile_act_rules(k) == jshlib.profile_act_rules(k)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_param_spec_equals_reference_for_every_leaf(arch):
    abstract = jspecs.abstract_params(jreg.get_config(arch))
    leaves = jax.tree_util.tree_flatten_with_path(abstract)[0]
    assert leaves
    n = 0
    for shape, axes in SPEC_MESHES.items():
        stand_in = types.SimpleNamespace(axis_names=axes,
                                         devices=np.empty(shape))
        for profile in ("tp", "dp"):
            for fsdp in (False, True):
                for path, leaf in leaves:
                    name = jshlib.path_str(path)
                    want = jshlib.param_spec(name, leaf.shape, stand_in,
                                             fsdp=fsdp, profile=profile)
                    got = shlib.param_spec(name, leaf.shape,
                                           dict(zip(axes, shape)),
                                           fsdp=fsdp, profile=profile)
                    assert got == tuple(want), (name, shape, profile, fsdp)
                    n += 1
    assert n == len(leaves) * len(SPEC_MESHES) * 4


@pytest.mark.parametrize("profile", ["tp", "dp"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_port_tree_paths_give_the_references_specs(profile, fsdp):
    """``param_shardings`` over the port's own mamba2 tree (its paths
    spelled by ``repro_torch.tree``) gives the specs of the reference's
    ``param_shardings`` over its tree, leaf by leaf."""
    cfg = cases.config()
    jcfg, _ = _model_params()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    want = jshlib.param_shardings(jspecs.abstract_params(jcfg), mesh,
                                  fsdp=fsdp, profile=profile)
    want = {jshlib.path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    sizes = {"data": 2, "model": 4}
    got = {path_str(p): sh.spec for p, sh in tree_leaves_with_path(
        shlib.param_shardings(tssm.abstract_params(cfg), sizes, fsdp=fsdp,
                              profile=profile))}
    assert got == want


@pytest.mark.parametrize("profile", ["tp", "dp"])
def test_batch_spec_is_the_references_batch_shardings(profile):
    for shape, axes in ((2, 4), ("data", "model")), ((2, 2, 2), (
            "pod", "data", "model")):
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), axes)
        for b in (8, 4, 2, 3):
            batch = {"tokens": jax.ShapeDtypeStruct((b, 16), jnp.int32),
                     "labels": jax.ShapeDtypeStruct((b, 16), jnp.int32),
                     "positions": jax.ShapeDtypeStruct((3, b, 16),
                                                       jnp.int32)}
            want = jsteps.batch_shardings(batch, mesh, profile)
            sizes = dict(zip(axes, shape))
            for k, v in batch.items():
                got = shlib.batch_spec(k, v.shape, sizes, profile)
                assert got == tuple(want[k].spec), (k, b, shape, profile)


def test_safe_spec_candidates_and_constrain_identity():
    sizes = {"data": 2, "model": 4}
    stand_in = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty((2, 4)))
    for shape, wanted in [((8, 2, 16, 4), jshlib.DEFAULT_ACT_RULES[
            "cache_blgd"]), ((8, 8, 6), ("pod", "model", None)),
            ((6, 4), (("pod", "data", "model"), None)), ((2, 2), (None,))]:
        assert shlib.safe_spec(shape, wanted, sizes) == tuple(
            jshlib.safe_spec(shape, wanted, stand_in))
    x = torch.randn(2, 3)
    with shlib.rules_context(sizes, shlib.profile_act_rules("dp")):
        assert shlib.constrain(x, "act_bsd") is x
        with shlib.rules_context(sizes):
            assert shlib.constrain(x, "logits_bsv") is x
    assert shlib.constrain(x, "act_bsd") is x


def test_parse_mesh_is_the_references_grammar():
    assert tmesh.parse_mesh("2x4") == ((2, 4), ("data", "model"))
    assert tmesh.parse_mesh("2x16x16") == ((2, 16, 16),
                                           ("pod", "data", "model"))
    for bad in ("4", "2x2x2x2", "0x1", "axb", ""):
        with pytest.raises(ValueError, match="--mesh"):
            tmesh.parse_mesh(bad)
    assert tmesh.PRODUCTION_MESHES[False] == ((16, 16), ("data", "model"))
    assert tmesh.PRODUCTION_MESHES[True] == ((2, 16, 16),
                                             ("pod", "data", "model"))
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(device="cpu")


def test_production_mesh_and_product_groups_on_ranks(spawned):
    for rank, (_, (errors, ranks, index), _) in enumerate(
            _result(spawned, "sync")):
        assert len(errors) == 2, errors
        assert "256 ranks" in errors[0] and "512 ranks" in errors[1]
        assert all("this group has 8" in e for e in errors)
        assert ranks == list(range(8))
        assert index == rank


# --- grad_sync --------------------------------------------------------------------


def _jmesh():
    shape, axes = SYNC_MESH
    return Mesh(np.array(jax.devices()[:8]).reshape(shape), axes)


def _jsum(fn, x):
    return np.asarray(jax.jit(_shard_map(fn, _jmesh(), P(("pod", "data")),
                                         P(None)))(jnp.asarray(x)))


def _max_rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def test_hierarchical_psum_matches_flat_and_reference(spawned):
    w, v, _ = _sync_inputs()
    want = {
        "w": _jsum(lambda x: jgs.hierarchical_psum(x, "data", "pod"), w),
        "v": _jsum(lambda x: jgs.hierarchical_psum(x, "data", "pod"), v),
    }
    flat = {k: x.reshape(8, -1, x.shape[-1]).sum(0) for k, x in
            (("w", w.astype(np.float64)), ("v", v.astype(np.float64)))}
    for rank, (out, _, _) in enumerate(_result(spawned, "sync")):
        for k in ("w", "v"):
            assert out["hier"][k].shape == want[k].shape
            assert _max_rel(out["hier"][k], want[k]) <= 1e-5, (rank, k)
            assert _max_rel(out["hier"][k], out["flat"][k]) <= 1e-5
            assert _max_rel(out["flat"][k], flat[k]) <= 1e-5


def test_compressed_psum_tree_matches_reference(spawned):
    w, v, _ = _sync_inputs()
    axes = ("pod", "data")

    def both(x, y):
        (s1, r1) = jgs.compressed_psum_tree({"w": x, "v": y}, axes)
        (s2, r2) = jgs.compressed_psum_tree({"w": x, "v": y}, axes,
                                            error_feedback=r1)
        return s1, r1, s2, r2

    spec = P(("pod", "data"))
    s1, r1, s2, r2 = (jax.tree.map(np.asarray, t) for t in jax.jit(
        _shard_map(both, _jmesh(), (spec, spec),
                   (P(None), spec, P(None), spec)))(jnp.asarray(w),
                                                     jnp.asarray(v)))
    out = [o for o, _, _ in _result(spawned, "sync")]
    for name, want in (("resid", r1), ("resid2", r2)):
        for k in ("w", "v"):
            got = np.concatenate([o[name][k] for o in out])
            assert np.array_equal(got, want[k]), (name, k)
            assert np.abs(got).max() > 0
    for name, want in (("comp", s1), ("comp2", s2)):
        for rank, o in enumerate(out):
            for k in ("w", "v"):
                assert o[name][k].dtype == np.float32
                assert _max_rel(o[name][k], want[k]) <= 2e-2, (name, k)
                assert _max_rel(o[name][k], o["flat"][k]) <= 2e-2


def test_checkpoint_restores_elastically_onto_a_mesh(spawned):
    """``tests/test_distrib.py:280``'s checkpoint: keep-2, then restored
    onto a mesh with ``a`` cut over (pod, data): each rank's blocks."""
    a = np.arange(32, dtype=np.float32).reshape(4, 8)
    for rank, (_, _, (step, block, b)) in enumerate(_result(spawned, "sync")):
        pod, data = divmod(rank, 4)
        assert step == 30
        assert np.array_equal(block, a[2 * pod:2 * pod + 2,
                                       2 * data:2 * data + 2])
        assert np.array_equal(b, np.ones(16, np.int32))


def test_accumulate_grads_matches_reference_on_a_linear_loss():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    x = rng.standard_normal((4, 16, 8)).astype(np.float32)
    y = rng.standard_normal((4, 16, 4)).astype(np.float32)

    def jloss(p, batch):
        pred = batch["x"] @ p["w"]
        return jnp.mean((pred - batch["y"]) ** 2), {}

    def tloss(p, batch):
        pred = batch["x"] @ p["w"]
        return ((pred - batch["y"]) ** 2).mean(), {}

    jl, jg = jgs.accumulate_grads(jloss, {"w": jnp.asarray(w)},
                                  {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tp = {"w": torch.from_numpy(w)}
    tl, tg = grad_sync.accumulate_grads(
        tloss, tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]),
                               rtol=1e-5, atol=1e-6)
    assert tp["w"].grad is None and tg["w"].dtype == torch.float32


def test_accumulate_grads_matches_reference_on_reduced_mamba2():
    jcfg, jparams = _model_params()
    cfg = cases.config()
    ds = MarkovLMDataset(512, 32, seed=9)
    rows = ds.batch(0, 0, 4)
    micro = {k: v.reshape(2, 2, 32) for k, v in rows.items()}
    jl, jg = jax.jit(lambda p, mb: jgs.accumulate_grads(
        lambda q, b: jssm.lm_loss(q, jcfg, b), p, mb))(
            jparams, {k: jnp.asarray(v) for k, v in micro.items()})
    tparams = convert.ssm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        tl, tg = grad_sync.accumulate_grads(
            lambda q, b: tssm.lm_loss(q, cfg, b), tparams,
            {k: torch.from_numpy(v) for k, v in micro.items()})
        _, _, full = tsteps.make_grad_step(cfg, device="cpu")(
            tparams, {k: torch.from_numpy(v) for k, v in rows.items()})
    finally:
        torch.set_num_threads(threads)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = {jshlib.path_str(p): np.asarray(g, np.float64) for p, g in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = cases.flat(tg)
    whole = cases.flat(full)
    assert set(got) == set(want)
    for k, g in got.items():
        assert np.linalg.norm(g - want[k]) <= 1e-5 * np.linalg.norm(
            want[k]), k
        assert np.linalg.norm(g - whole[k]) <= 1e-5 * np.linalg.norm(
            whole[k]), k


# --- the elastic checkpoint of a ZeRO run -----------------------------------------------


def test_zero_checkpoint_continues_on_other_meshes(spawned):
    jobs, params_np, ckpt = spawned
    saved, restored = jobs["elastic"].result()
    uninterrupted = saved[0]
    assert all(s == uninterrupted for s in saved)
    at_from = DATA["save_at"]
    for at, cut_ok, losses in restored:
        assert at == at_from and cut_ok
        np.testing.assert_allclose(losses, uninterrupted[at:], rtol=1e-5)
    # and on one process, without a mesh
    cfg = cases.config()
    params = convert.ssm_params_from_numpy(params_np, device="cpu")
    state, at = CheckpointManager(ckpt).restore(
        {"params": params, "opt": adamw_init(params)})
    assert at == at_from and int(state["opt"].step) == at_from
    step = tsteps.make_train_step(cfg, AdamWConfig(**OPT), device="cpu")
    ds = MarkovLMDataset(DATA["vocab"], DATA["seq"], seed=DATA["seed"])
    losses = []
    params, opt = state["params"], state["opt"]
    for i in range(at, DATA["steps"]):
        batch = {k: torch.from_numpy(v)
                 for k, v in ds.batch(i, 0, DATA["batch"]).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, uninterrupted[at:], rtol=1e-5)


# --- the train CLI over a mesh ------------------------------------------------------------


def _logged(stdout: str):
    return [line.split()[:4] for line in stdout.splitlines()
            if line.startswith("step ")]


def test_train_cli_over_two_gloo_ranks_matches_one_process(spawned):
    one, two = (_result(spawned, k) for k in ("cli1", "cli2"))
    assert one.returncode == 0, one.stderr
    assert two.returncode == 0, two.stderr
    assert _logged(two.stdout) == _logged(one.stdout)
    steps = [s[1] for s in _logged(two.stdout)]
    assert steps == ["0", "1", "2", "2", "3", "4", "5"], steps
    done = next(x for x in two.stdout.splitlines() if x.startswith("done:"))
    assert "restarts=1" in done and "mesh=2x1" in done
    assert "device=cpu" in done
    assert "2 data-parallel ranks, 1 rows each" in two.stdout
    # every rank restored the same step, in lockstep
    assert len(re.findall("restored at step 2", two.stderr)) == 2


def test_train_cli_mesh_checkpoint_continues_on_one_process(spawned):
    """The 2x1 run's last checkpoint (whole leaves, rank 0's) restored on
    one process without a mesh: 2 more steps of the CLI's own loop."""
    two = _result(spawned, "cli2")
    assert two.returncode == 0, two.stderr
    ckpt = CheckpointManager(str(next(a for a in two.args if "cli2" in
                                      str(a))))
    assert ckpt.all_steps() == [2, 4, 6]
    cfg = cases.config()
    params = tssm.init_params(cfg, seed=0, device="cpu")
    state, at = ckpt.restore({"params": params, "opt": adamw_init(params)})
    assert at == 6 and int(state["opt"].step) == 6
    step = tsteps.make_train_step(
        cfg, AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=8),
        device="cpu")
    data = MarkovLMDataset(cfg.vocab, 32, branching=4)
    params, opt = state["params"], state["opt"]
    for i in (6, 7):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(i, 0,
                                                               2).items()}
        params, opt, m = step(params, opt, batch)
        assert np.isfinite(float(m["loss"]))
    assert int(opt.step) == 8


def test_train_cli_refuses_nccl_without_a_card_per_rank_and_tensor_parallel():
    """Kept under its name from before mamba2's tensor parallelism was
    ported: nccl without a card per rank is still refused; the tensor-
    parallel meshes that raised now train (``--mesh 1x2`` over two gloo
    CPU ranks, two steps; ``tests/test_torch_tp.py`` holds the losses
    to ``--mesh 1x1``'s)."""
    with pytest.raises(RuntimeError, match="one card per rank"):
        ttrain.main(["--reduced", "--device", "cpu", "--mesh", "2x1",
                     "--backend", "nccl"])
    if torch.cuda.device_count() < 4:
        with pytest.raises(RuntimeError, match="one card per rank"):
            ttrain.main(["--reduced", "--mesh", "4x1", "--backend", "nccl"])
    with pytest.raises(RuntimeError, match="one card per rank"):
        ttrain.main(["--reduced", "--device", "cpu", "--mesh", "1x2x2",
                     "--backend", "nccl"])
    with tempfile.TemporaryDirectory() as ckpt:
        assert ttrain.main(["--reduced", "--device", "cpu", "--mesh", "1x2",
                            "--backend", "gloo", "--steps", "2",
                            "--global-batch", "2", "--seq-len", "16",
                            "--ckpt-dir", ckpt]) is None
