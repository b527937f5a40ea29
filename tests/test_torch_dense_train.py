"""Training the dense transformer family in the port (``lm_loss`` and its
gradients, remat, ``make_train_step`` with and without donation, the
train CLI on one process and over a data-parallel mesh) against the JAX
package, at the five dense/VLM architectures' reduced configs
(``reduced_config``: 4 layers, d_model 64, 4 heads of 16, d_ff 128,
vocab 512), float32.

Both packages compute on the same weights: the JAX ``init_params`` tree
crosses through ``convert.model_params_from_numpy``; tokens are the
Markov dataset's numpy draws, the VLM's patch embeddings and M-RoPE
streams numpy draws from a seed.

Tolerances:
* the loss within 1e-5 relative (float32 sums in other orders);
* each gradient leaf within 1e-4 relative L2 (‖port − ref‖ / ‖ref‖);
* three train steps within 1e-4 relative L2 per leaf (the gradients'
  1e-4, through Adam's m̂/√v̂) over the elements whose Adam step the
  gradients fix; an element whose step-0 gradient is a near-cancellation
  (below ``SMALL_GRAD`` of its leaf's RMS: the k bias's slowly rotating
  dims, on which the softmax barely depends) may move by any amount in
  [-lr, lr] a step on two correct implementations, and is held to
  2·Σ lr, as ``tests/test_torch_dp_train.py`` holds them;
* remat on and off, donation on and off: bit for bit (the same
  arithmetic).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jreg
from repro.distrib import sharding as jshlib
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.data import MarkovLMDataset
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_leaves_with_path, tree_map

ROOT = Path(__file__).resolve().parent.parent
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# A step-0 gradient element below SMALL_GRAD of its leaf's RMS leaves
# its Adam step unfixed (see the module docstring).
SMALL_GRAD = 3e-3
DENSE = ("qwen2.5-3b", "qwen2.5-14b", "gemma-2b", "llama3-8b",
         "qwen2-vl-7b")


@pytest.fixture(autouse=True)
def _f32_reference_and_two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with jax.enable_x64(False):
            yield
    finally:
        torch.set_num_threads(threads)


def _cfgs(arch, **kw):
    j = dataclasses.replace(jreg.reduced_config(jreg.get_config(arch)), **kw)
    t = dataclasses.replace(treg.reduced_config(treg.get_config(arch)), **kw)
    return j, t


def _params(jcfg, seed=0):
    params = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return params, convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


def _batch(cfg, b, s, step=0, seed=0):
    """(JAX batch, port batch): Markov rows of step ``step``; the VLM's
    patch embeddings and three M-RoPE streams besides."""
    nb = MarkovLMDataset(cfg.vocab, s, seed=seed).batch(step, 0, b)
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed + step)
        t = np.broadcast_to(np.arange(s), (b, s))
        nb["positions"] = np.stack([t, t // 4, t % 4]).astype(np.int32)
        nb["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in nb.items()})


def _flat(tree) -> dict[str, np.ndarray]:
    if isinstance(jax.tree_util.tree_leaves(tree)[0], jax.Array):
        return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in path): np.asarray(v, np.float64)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {"/".join(path): v.detach().double().numpy()
            for path, v in tree_leaves_with_path(tree)}


def _rel_l2(got, want) -> float:
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_trees_close(got, want, tol, what):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), (sorted(g), sorted(w))
    worst = {k: _rel_l2(g[k], w[k]) for k in w}
    assert max(worst.values()) <= tol, (what, worst)


def _assert_params_close(got, want, grads0, lr, tol, what):
    """``got`` within ``tol`` relative L2 per leaf of ``want`` over the
    elements whose step-0 gradient is zero or above ``SMALL_GRAD`` of
    its leaf's RMS, every other element within ``2 · sum(lr)``."""
    got, want, grads0 = _flat(got), _flat(want), _flat(grads0)
    assert set(got) == set(want), (sorted(got), sorted(want))
    worst, loose = {}, {}
    for k in want:
        g = grads0[k]
        fixed = ((np.abs(g) > SMALL_GRAD * np.sqrt(np.mean(np.square(g))))
                 | (g == 0))
        worst[k] = _rel_l2(got[k][fixed], want[k][fixed])
        if not fixed.all():
            loose[k] = float(np.abs(got[k] - want[k])[~fixed].max())
    assert max(worst.values()) <= tol, (what, worst)
    assert max(loose.values(), default=0.0) <= 2 * sum(lr), (what, loose)


def _assert_trees_equal(got, want):
    for (path, a), (_, b) in zip(tree_leaves_with_path(got),
                                 tree_leaves_with_path(want), strict=True):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_and_every_gradient_leaf_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=1)
    jb, tb = _batch(jcfg, 2, 32, seed=1)
    (want_loss, want_m), want_grads = jax.jit(
        jax.value_and_grad(jtr.lm_loss, has_aux=True), static_argnums=1,
    )(jp, jcfg, jb)
    loss, metrics, grads = tsteps.make_grad_step(tcfg, device="cpu")(tp, tb)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * float(want_loss)
    assert set(metrics) == set(want_m) == {"xent", "aux"}
    assert float(metrics["aux"]) == 0.0
    _assert_trees_close(grads, want_grads, GRAD_TOL, arch)
    # the patches' rows of the embedding get no gradient from the tokens
    # they replace, as in the reference
    if tcfg.family == "vlm":
        replaced = tb["tokens"][:, :tcfg.n_patches].unique()
        kept = tb["tokens"][:, tcfg.n_patches:].unique()
        only = replaced[~torch.isin(replaced, kept)]
        assert only.numel() and not grads["embed"][only].any()


@pytest.mark.parametrize("remat", ("selective", "full"))
def test_remat_gives_the_same_loss_and_gradients(remat):
    """Remat recomputes each layer from its input (and, selective, its
    saved projections): the same arithmetic, so the same bits."""
    _, plain_cfg = _cfgs("qwen2-vl-7b")
    _, remat_cfg = _cfgs("qwen2-vl-7b", remat=remat)
    tp = ttr.init_params(plain_cfg, seed=3, device="cpu")
    _, tb = _batch(plain_cfg, 2, 32, seed=3)
    (l0, _, g0), (l1, _, g1) = (
        tsteps.make_grad_step(c, device="cpu")(tp, tb)
        for c in (plain_cfg, remat_cfg))
    assert float(l0) == float(l1)
    _assert_trees_equal(g1, g0)


@pytest.mark.parametrize("remat,forwards", (("none", 1), ("selective", 2),
                                            ("full", 2)))
def test_remat_runs_each_layer_forward_twice(monkeypatch, remat, forwards):
    """Under remat the backward runs every layer's attention again;
    serving (no grad) runs each layer once whatever the config says."""
    calls = []
    plain = tl.attention

    def counting(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return plain(*a, **kw)

    monkeypatch.setattr(tl, "attention", counting)
    _, cfg = _cfgs("llama3-8b", remat=remat)
    tp = ttr.init_params(cfg, seed=0, device="cpu")
    _, tb = _batch(cfg, 1, 16)
    tsteps.make_grad_step(cfg, device="cpu")(tp, tb)
    assert len(calls) == forwards * cfg.n_layers, calls
    calls.clear()
    with torch.no_grad():
        ttr.forward(tp, cfg, tb["tokens"])
    assert len(calls) == cfg.n_layers


class _CountMM(TorchDispatchMode):
    """Counts ``aten.mm`` calls (the projections) while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_selective_remat_keeps_the_projections():
    """The backward's matrix products: under selective remat as many as
    without remat (each layer's ``aten.mm`` outputs are kept, the rest
    recomputed), under full remat more (the projections recomputed)."""
    counts = {}
    for remat in ("none", "selective", "full"):
        _, cfg = _cfgs("qwen2.5-3b", remat=remat, n_layers=2)
        leaves = tree_map(lambda p: p.requires_grad_(),
                          ttr.init_params(cfg, seed=0, device="cpu"))
        _, tb = _batch(cfg, 1, 16)
        loss, _ = ttr.lm_loss(leaves, cfg, tb)
        with _CountMM() as mm:
            loss.backward()
        counts[remat] = mm.n
    assert counts["selective"] == counts["none"] < counts["full"], counts


def test_make_train_step_matches_reference_jit_train_step():
    """Three steps of the port's ``make_train_step`` against the
    reference's ``jit_train_step`` on a one-device mesh, the tied
    qwen2.5-3b with its QKV bias; donation gives the same bits."""
    jcfg, tcfg = _cfgs("qwen2.5-3b")
    opt_kw = dict(lr_peak=3e-3, warmup_steps=1, total_steps=3)
    jp, tp = _params(jcfg, seed=4)
    batches = [_batch(jcfg, 2, 32, step=i, seed=4) for i in range(3)]
    batch_abs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in batches[0][0].items()}
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with jshlib.rules_context(mesh, jshlib.profile_act_rules("tp")):
        jstep, (p_sh, o_sh, b_sh) = jsteps.jit_train_step(
            jcfg, mesh, batch_abs, opt_cfg=jadamw.AdamWConfig(**opt_kw),
            donate=False)
        jp = jax.device_put(jp, p_sh)
        jo = jax.device_put(jadamw.adamw_init(jp), o_sh)
        jms = []
        for jb, _ in batches:
            jp, jo, jm = jstep(jp, jo, jb)
            jms.append(jm)
    opt_cfg = tadamw.AdamWConfig(**opt_kw)
    runs = {}
    for donate in (False, True):
        step = tsteps.make_train_step(tcfg, opt_cfg, device="cpu",
                                      donate=donate)
        p = tree_map(torch.clone, tp)
        o = tadamw.adamw_init(p)
        first = p["blocks"]["wq"]
        for (_, tb), jm in zip(batches, jms):
            p, o, tm = step(p, o, tb)
            assert set(tm) == set(jm) == {"xent", "aux", "loss",
                                          "grad_norm", "lr"}
            for k in ("loss", "grad_norm"):
                assert abs(float(tm[k]) - float(jm[k])) <= \
                    GRAD_TOL * float(jm[k]), k
        # donated: written into the given tensors
        assert (p["blocks"]["wq"] is first) == donate
        runs[donate] = (p, o)
    _assert_trees_equal(runs[True][0], runs[False][0])
    _assert_trees_equal(runs[True][1].mu, runs[False][1].mu)
    _, _, grads0 = tsteps.make_grad_step(tcfg, device="cpu")(tp,
                                                              batches[0][1])
    _assert_params_close(runs[True][0], jp, grads0,
                         [float(m["lr"]) for m in jms], GRAD_TOL,
                         "params after 3 steps")
    _assert_trees_close(runs[True][1].nu, jo.nu, GRAD_TOL, "nu")


def test_training_reduces_loss_on_markov_data():
    """``tests/test_system.py:33`` in the port: a small dense model
    learns an order-1 Markov chain (the loss falls by more than a nat
    toward ln 4 from about ln 64)."""
    cfg = dataclasses.replace(
        treg.get_config("qwen2.5-3b"), n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=64, dtype="float32",
        remat="none")
    ds = MarkovLMDataset(vocab=64, seq_len=64, branching=4, seed=1)
    params = ttr.init_params(cfg, seed=0, device="cpu")
    opt_cfg = tadamw.AdamWConfig(lr_peak=5e-3, warmup_steps=5,
                                 total_steps=80)
    step = tsteps.make_train_step(cfg, opt_cfg, device="cpu", donate=True)
    opt = tadamw.adamw_init(params)
    losses = []
    for i in range(80):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch(i, 0, 16).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_tensor_parallel_profile_still_raises_for_a_dense_model():
    """Kept under its name from before tensor parallelism was ported:
    the tp profile now builds the dense plan on a model axis above one
    rank (the heads, FFN and vocab cut over ``model``), with and without
    ZeRO, and so it does for mamba2 (``in_proj``'s columns, the conv
    taps, the per-head leaves over ``model``; under ZeRO ``in_proj``
    also over ``data``), which raised until its tensor parallelism was
    ported; the dp profile and a model axis of 1 pass as before."""
    _, cfg = _cfgs("llama3-8b")
    for sizes in ({"data": 2, "model": 2}, {"data": 1, "model": 4}):
        for fsdp in (False, True):
            p_sh, o_sh = tsteps.train_shardings(cfg, sizes, fsdp=fsdp)
            specs = {"/".join(p): sh.spec
                     for p, sh in tree_leaves_with_path(p_sh)}
            assert specs["blocks/wq"][2] == "model"
            assert specs["blocks/w_down"][1] == "model"
            assert specs["embed"][0] == "model"
            assert o_sh.mu is p_sh
    mamba = treg.reduced_config(treg.get_config("mamba2-780m"))
    for fsdp in (False, True):
        p_sh, _ = tsteps.train_shardings(mamba, {"data": 2, "model": 2},
                                         fsdp=fsdp)
        specs = {"/".join(p): sh.spec for p, sh in tree_leaves_with_path(p_sh)}
        assert specs["blocks/in_proj"] == ((None, "data", "model") if fsdp
                                           else (None, None, "model"))
        assert specs["blocks/conv_w"] == (None, "model")
        assert specs["blocks/A_log"] == (None, "model")
        assert specs["blocks/ln1"] == ()
    tsteps.train_shardings(cfg, {"data": 1, "model": 2}, profile="dp")
    tsteps.train_shardings(cfg, {"data": 4, "model": 1}, fsdp=True)


# The port's bf16 gradient leaf may lie at most BF16_GRAD_MULTIPLE times
# as far from the reference's f32 gradient as the reference's own bf16
# gradient does (fixed before the test first ran).
BF16_GRAD_MULTIPLE = 1.5


@pytest.mark.parametrize("seed", (1, 2))
def test_bf16_gradients_lie_as_near_the_f32_reference_as_its_own_bf16(seed):
    """bf16 training gradients of reduced qwen2.5-3b against the
    reference: bf16 rounds a near-cancelled leaf's sum coarsely in
    either package (``bk`` lies 2-5e-2 from its f32 gradient in both),
    so each of the port's bf16 leaves is held to ``BF16_GRAD_MULTIPLE``
    times the reference's own bf16-to-f32 distance, relative L2."""
    jcfg, tcfg = _cfgs("qwen2.5-3b")
    jp, tp = _params(jcfg, seed=seed)
    jb, tb = _batch(jcfg, 2, 32, seed=seed)
    grad = jax.jit(jax.value_and_grad(jtr.lm_loss, has_aux=True),
                   static_argnums=1)
    _, want = grad(jp, jcfg, jb)
    _, ref_bf16 = grad(jp, dataclasses.replace(jcfg, dtype="bfloat16"), jb)
    bf16 = dataclasses.replace(tcfg, dtype="bfloat16")
    _, _, got = tsteps.make_grad_step(bf16, device="cpu")(tp, tb)
    got, want, ref_bf16 = _flat(got), _flat(want), _flat(ref_bf16)
    assert set(got) == set(want)
    ratios = {k: _rel_l2(got[k], want[k]) / _rel_l2(ref_bf16[k], want[k])
              for k in want}
    assert max(ratios.values()) <= BF16_GRAD_MULTIPLE, ratios


def _logged(stdout: str) -> list[list[str]]:
    return [line.split()[:4] for line in stdout.splitlines()
            if line.startswith("step ")]


def test_train_cli_trains_a_dense_model_on_one_process_and_over_a_mesh(
        tmp_path):
    """The CLI with ``--arch qwen2.5-3b`` on the CPU, restarting once from
    its checkpoint; then over two gloo ranks (mesh 2x1, the batch cut
    over ``data``): the same logged losses."""
    common = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
              "--steps", "6", "--global-batch", "2", "--seq-len", "32",
              "--ckpt-every", "2", "--simulate-failure-at", "3",
              "--log-every", "1"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {
        name: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *common,
             *extra, "--ckpt-dir", str(tmp_path / name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for name, extra in (("one", []),
                            ("two", ["--mesh", "2x1", "--backend", "gloo"]))}
    outs = {k: p.communicate(timeout=300) + (p.returncode,)
            for k, p in procs.items()}
    for name, (out, err, rc) in outs.items():
        assert rc == 0, (name, err)
        done = next(x for x in out.splitlines() if x.startswith("done:"))
        assert "restarts=1" in done and "arch=qwen2.5-3b" in done
        assert "conv1d_depthwise" not in done
        assert re.search("restored at step 2", err)
    one, two = (_logged(outs[k][0]) for k in ("one", "two"))
    assert [s[1] for s in one] == ["0", "1", "2", "2", "3", "4", "5"]
    assert one == two
    assert all(np.isfinite(float(s[3])) for s in one)
