"""Training in the port (``repro_torch``: ``token_xent``, ``lm_loss`` with
remat, B7 under autograd, AdamW, the data pipeline, the supervisor, the
train step and its CLI) against the JAX package, at the reference's
reduced mamba2 (``reduced_config``: 4 layers, d_model 64, state 16, head
dim 8, chunk 16, vocab 512), float32.

Both packages compute on the same weights: the JAX ``init_params`` tree
crosses through ``convert.ssm_params_from_numpy``; tokens are the
datasets' numpy draws. On the CPU the JAX ``forward`` takes the plain
conv, and the port's B7 wrapper its plain version.

Tolerances:
* the loss within 1e-5 relative (float32 sums in other orders);
* each gradient leaf within 1e-4 relative L2 (‖port − ref‖ / ‖ref‖):
  3.9e-6 is the largest seen at chunk 16 (the same function in other
  orders), 2.4e-5 at chunk 256 against the reference at chunk 16 (the
  same function chunked otherwise);
* AdamW, the schedule and clipping within 1e-6 relative (the same
  float32 formula; the global norm's sum in another order);
* three train steps within 1e-4 relative L2 per leaf (the gradients'
  1e-4, through Adam's m̂/√v̂, which follows the gradient's sign);
* batches, the weight-decay rule and the supervisor's replays exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import pipeline as jdata
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tdata
from repro_torch.ft import SimulatedFailure, Supervisor
from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_leaves_with_path

ROOT = Path(__file__).resolve().parent.parent
ARCH = "mamba2-780m"
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6


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


def _cfgs(**kw):
    """(JAX cfg, port cfg): the reduced mamba2 in float32 with ``kw``."""
    j = dataclasses.replace(jreg.reduced_config(jreg.get_config(ARCH)), **kw)
    t = dataclasses.replace(treg.reduced_config(treg.get_config(ARCH)), **kw)
    return j, t


def _params(jcfg, seed=0):
    """(JAX params, the same weights as port tensors on the CPU)."""
    params = jssm.init_params(jcfg, jax.random.PRNGKey(seed))
    return params, convert.ssm_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


def _batch(vocab, b, s, step=0, seed=0):
    """(JAX batch, port batch): Markov rows of step ``step``."""
    nb = tdata.MarkovLMDataset(vocab, s, seed=seed).batch(step, 0, b)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _flat(tree) -> dict[str, np.ndarray]:
    """{"a/b": array} of a JAX or port tree, by the reference's paths."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], jax.Array):
        return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in path): np.asarray(v, np.float64)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {"/".join(path): v.detach().double().numpy()
            for path, v in tree_leaves_with_path(tree)}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _assert_trees_close(got, want, tol, what):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), (sorted(g), sorted(w))
    worst = {k: _rel_l2(g[k], w[k]) for k in w}
    assert max(worst.values()) <= tol, (what, worst)


def _jax_value_and_grad(jparams, jcfg, jbatch):
    (loss, _), grads = jax.jit(
        jax.value_and_grad(jssm.lm_loss, has_aux=True), static_argnums=1,
    )(jparams, jcfg, jbatch)
    return float(loss), grads


# --- token_xent -----------------------------------------------------------------


@pytest.mark.parametrize("masked", (False, True))
def test_token_xent_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 16, 96))).astype(np.float32)
    labels = rng.integers(0, 96, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.6).astype(np.float32) if masked else None
    want = jlayers.token_xent(jnp.asarray(logits), jnp.asarray(labels),
                              None if mask is None else jnp.asarray(mask))
    got = tlayers.token_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    if masked:  # an all-zero mask divides by 1, as the reference's
        zero = torch.zeros((2, 16))
        assert float(tlayers.token_xent(torch.from_numpy(logits),
                                        torch.from_numpy(labels), zero)) == 0.0


# --- lm_loss and its gradients ------------------------------------------------------


def test_lm_loss_and_every_gradient_leaf_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    jb, tb = _batch(jcfg.vocab, 2, 32, seed=1)
    want_loss, want_grads = _jax_value_and_grad(jp, jcfg, jb)
    loss, metrics, grads = tsteps.make_grad_step(tcfg, device="cpu")(tp, tb)
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert float(metrics["xent"]) == float(loss)
    _assert_trees_close(grads, want_grads, GRAD_TOL, "grads at chunk 16")
    loss2, _ = treg.get_model(tcfg).lm_loss(tp, tcfg, tb)
    assert float(loss2) == float(loss)


def test_grads_at_chunk_256_are_finite_and_match_reference_at_16():
    """mamba2-780m trains at chunk 256. The port masks the intra-chunk
    decay before ``exp``; its gradients are finite there and equal the
    reference's at chunk 16 (the same function, chunked otherwise)."""
    jcfg16, _ = _cfgs()
    _, tcfg256 = _cfgs(ssm_chunk=256)
    jp, tp = _params(jcfg16, seed=2)
    jb, tb = _batch(jcfg16.vocab, 2, 256, seed=2)
    want_loss, want_grads = _jax_value_and_grad(jp, jcfg16, jb)
    loss, _, grads = tsteps.make_grad_step(tcfg256, device="cpu")(tp, tb)
    for path, g in tree_leaves_with_path(grads):
        assert bool(torch.isfinite(g).all()), path
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    _assert_trees_close(grads, want_grads, GRAD_TOL, "chunk 256 vs 16")


def test_reference_grads_at_chunk_256_are_not_finite():
    """The fault ROADMAP section C records in the reference (not the
    port): exp over the whole chunk square, zeroed above the diagonal
    afterwards, overflows there, and the backward multiplies 0 by
    inf."""
    jcfg, _ = _cfgs(ssm_chunk=256)
    jp, _ = _params(jcfg, seed=2)
    jb, _ = _batch(jcfg.vocab, 2, 256, seed=2)
    loss, grads = _jax_value_and_grad(jp, jcfg, jb)
    assert np.isfinite(loss)
    bad = [k for k, v in _flat(grads).items() if not np.isfinite(v).all()]
    assert bad, "the reference's chunk-256 gradients became finite"


@pytest.mark.parametrize("use_pallas_conv", (True, False))
def test_remat_gives_the_same_loss_and_gradients(use_pallas_conv):
    """Selective remat recomputes each layer from its input and saved
    projections: the same arithmetic, so the same bits."""
    _, plain_cfg = _cfgs()
    _, remat_cfg = _cfgs(remat="selective")
    tp = tssm.init_params(plain_cfg, seed=3, device="cpu")
    _, tb = _batch(plain_cfg.vocab, 2, 32, seed=3)
    outs = [tsteps.make_grad_step(c, device="cpu",
                                  use_pallas_conv=use_pallas_conv)(tp, tb)
            for c in (plain_cfg, remat_cfg)]
    (l0, _, g0), (l1, _, g1) = outs
    assert float(l0) == float(l1)
    for (path, a), (_, b) in zip(tree_leaves_with_path(g0),
                                 tree_leaves_with_path(g1)):
        assert torch.equal(a, b), path


def test_remat_runs_each_layer_forward_twice(monkeypatch):
    """Under remat the backward runs every layer's forward again, the
    conv's included (on the card: a second B7 launch a layer); the conv's
    gradient runs its plain version once a layer either way."""
    calls = {"forward": 0, "backward": 0}
    plain = kref.conv1d_depthwise

    def counting(x, w, activation="none"):
        calls["backward" if torch.is_grad_enabled() else "forward"] += 1
        return plain(x, w, activation)

    monkeypatch.setattr(kref, "conv1d_depthwise", counting)
    for remat, forwards in (("none", 1), ("selective", 2)):
        _, cfg = _cfgs(remat=remat)
        tp = tssm.init_params(cfg, seed=0, device="cpu")
        _, tb = _batch(cfg.vocab, 1, 16)
        calls.update(forward=0, backward=0)
        tsteps.make_grad_step(cfg, device="cpu", use_pallas_conv=True)(tp, tb)
        assert calls == {"forward": forwards * cfg.n_layers,
                         "backward": cfg.n_layers}, (remat, calls)


# --- B7 under autograd ----------------------------------------------------------------


@pytest.mark.parametrize("activation", ("none", "silu"))
def test_conv1d_function_gradcheck_f64(activation):
    """The ``Function``'s backward (the plain version's gradient) against
    finite differences, on a strided column view as mamba2's xBC is."""
    rng = np.random.default_rng(4)
    base = torch.from_numpy(rng.standard_normal((2, 9, 11))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((4, 5))).requires_grad_()

    def fn(base, w):
        return kops.conv1d_depthwise(base[..., 3:8], w, activation=activation)

    assert torch.autograd.gradcheck(fn, (base, w))
    y = fn(base, w)
    assert type(y.grad_fn).__name__ == "Conv1dDepthwiseBackward"
    gy = torch.from_numpy(rng.standard_normal(y.shape))
    gb, gw = torch.autograd.grad(y, (base, w), gy)
    assert bool((gb[..., :3] == 0).all() and (gb[..., 8:] == 0).all())
    want = torch.autograd.grad(
        kref.conv1d_depthwise(base[..., 3:8], w, activation), (base, w), gy)
    assert torch.equal(gb, want[0]) and torch.equal(gw, want[1])


def test_conv1d_without_a_gradient_builds_no_graph():
    x = torch.randn(2, 8, 6, requires_grad=True)
    w = torch.randn(4, 6, requires_grad=True)
    with torch.no_grad():
        y = kops.conv1d_depthwise(x, w)
    assert y.grad_fn is None and not y.requires_grad
    y = kops.conv1d_depthwise(x.detach(), w.detach())
    assert y.grad_fn is None
    with pytest.raises(ValueError, match="no_grad"):
        kc.conv1d_depthwise_cuda(x, w, out=torch.empty(2, 8, 6))


# --- AdamW ------------------------------------------------------------------------------


def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (12, 8), "blocks": {"in_proj": (2, 8, 6),
                                           "ln1": (2, 8), "A_log": (2, 3),
                                           "conv_b": (2, 6)},
              "final_norm": (8,)}

    def draw(tree, scale):
        if isinstance(tree, dict):
            return {k: draw(v, scale) for k, v in tree.items()}
        return (scale * rng.standard_normal(tree)).astype(np.float32)

    return draw(shapes, 1.0), [draw(shapes, s) for s in (0.3, 2.0, 0.05)]


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return convert.ssm_params_from_numpy(tree, device="cpu")


def test_adamw_update_matches_reference_over_three_steps():
    """Step 2's gradients have a global norm above ``clip_norm`` (1.0),
    so clipping acts; the decay rule spares ``ln1``, ``A_log``,
    ``conv_b`` and ``final_norm``."""
    cfg_kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=5)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    params, grads = _opt_trees()
    jp, tp = _j(params), _t(params)
    jst, tst = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for g in grads:
        jp, jst, jm = jadamw.adamw_update(jcfg, _j(g), jst, jp)
        tp, tst, tm = tadamw.adamw_update(tcfg, _t(g), tst, tp)
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= OPT_TOL * float(jm[k])
        assert int(tst.step) == int(jst.step)
        assert tst.step.dtype == torch.int32
        for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
            _assert_trees_close(got, want, OPT_TOL, "adamw")
    assert not any(t.requires_grad for _, t in tree_leaves_with_path(tp))


def test_cosine_schedule_matches_reference():
    for kw in (dict(warmup_steps=10, total_steps=100),
               dict(warmup_steps=0, total_steps=1),
               dict(warmup_steps=5, total_steps=5, lr_min_ratio=0.0)):
        jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
        for step in (0, 1, 4, 5, 6, 10, 11, 50, 99, 100, 150):
            want = float(jadamw.cosine_schedule(jcfg, jnp.int32(step)))
            got = float(tadamw.cosine_schedule(
                tcfg, torch.tensor(step, dtype=torch.int32)))
            assert abs(got - want) <= OPT_TOL * max(abs(want), 1e-12), (
                kw, step, got, want)


@pytest.mark.parametrize("max_norm", (0.5, 100.0))
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = _opt_trees(seed=1)
    jg, jn = jadamw.clip_by_global_norm(_j(grads[1]), max_norm)
    tg, tn = tadamw.clip_by_global_norm(_t(grads[1]), max_norm)
    assert abs(float(tn) - float(jn)) <= OPT_TOL * float(jn)
    _assert_trees_close(tg, jg, OPT_TOL, "clip")


def test_no_decay_rule_matches_reference():
    """``_decays`` on every path of a train state (params and both
    moments) and on names that hit each ``_NO_DECAY`` entry."""
    jcfg, _ = _cfgs()
    jp = jssm.init_params(jcfg, jax.random.PRNGKey(0))
    state = {"params": jp, "opt": jadamw.adamw_init(jp),
             "extra": {n: jnp.zeros(()) for n in (
                 "w_q", "bq", "b_in", "pos_emb", "a_param", "wo", "D_skip",
                 "attn_norm", "lnf", "mlp_bias", "bk", "bv", "bo", "kernel")}}
    assert tadamw._NO_DECAY == jadamw._NO_DECAY
    seen = set()
    for path, _ in jax.tree_util.tree_flatten_with_path(state)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path)
        assert tadamw._decays(keys) == jadamw._decays(path), keys
        seen.add(tadamw._decays(keys))
    assert seen == {True, False}


# --- data ---------------------------------------------------------------------------------


@pytest.mark.parametrize("dataset", ("synthetic", "markov"))
def test_batches_equal_reference_bit_for_bit(dataset):
    if dataset == "synthetic":
        pairs = [(jdata.SyntheticLMDataset(97, 33, seed=s),
                  tdata.SyntheticLMDataset(97, 33, seed=s)) for s in (0, 5)]
    else:
        pairs = [(jdata.MarkovLMDataset(97, 33, branching=b, seed=s),
                  tdata.MarkovLMDataset(97, 33, branching=b, seed=s))
                 for s, b in ((0, 4), (3, 2))]
        assert pairs[0][1].entropy_rate == pairs[0][0].entropy_rate
    for jd, td in pairs:
        for step, start, count in ((0, 0, 4), (7, 3, 2), (12, 0, 1)):
            want, got = jd.batch(step, start, count), td.batch(step, start,
                                                               count)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        for host in range(2):
            ji = jdata.BatchIterator(jd, 4, host_index=host, host_count=2,
                                     start_step=3)
            ti = tdata.BatchIterator(td, 4, host_index=host, host_count=2,
                                     start_step=3)
            for _ in range(2):
                want, got = ji.next_local(), ti.next_global("cpu")
                for k in want:
                    assert got[k].dtype == torch.int32
                    np.testing.assert_array_equal(got[k].numpy(), want[k])
            assert ti.step == ji.step == 5
    with pytest.raises(ValueError, match="divide"):
        tdata.BatchIterator(pairs[0][1], 3, host_index=0, host_count=2)
    np.testing.assert_array_equal(
        tdata.make_physics_init((4, 6), 3, 0.5, seed=2),
        jdata.make_physics_init((4, 6), 3, 0.5, seed=2))


def test_batch_iterator_takes_its_host_from_torch_distributed(tmp_path):
    ds = tdata.SyntheticLMDataset(50, 8)
    assert (tdata.BatchIterator(ds, 4).host_index,
            tdata.BatchIterator(ds, 4).host_count) == (0, 1)
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("gloo", store=store, rank=0,
                                         world_size=1)
    try:
        it = tdata.BatchIterator(ds, 4)
        assert (it.host_index, it.host_count, it.per_host) == (0, 1, 4)
    finally:
        torch.distributed.destroy_process_group()


# --- supervisor ------------------------------------------------------------------------------


def test_supervisor_recovers_from_failure(tmp_path):
    """``tests/test_distrib.py::test_supervisor_recovers_from_failure``
    on the port's manager and tensors."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    sup = Supervisor(mgr, ckpt_every=5)
    trace = []

    def step_fn(state, step):
        trace.append(step)
        return {"x": state["x"] + 1}

    def restore(state, step):
        if step is None:
            return {"x": torch.zeros(())}, 0
        return mgr.restore(state, step)

    state, report = sup.run({"x": torch.zeros(())}, step_fn, 20,
                            failure_at=12, restore_fn=restore)
    assert report["restarts"] == 1 and report["failed_steps"] == [12]
    assert float(state["x"]) == 20  # exact replay: 10 (ckpt) + 10 more
    assert trace.count(10) == 2 and trace.count(11) == 2
    assert mgr.all_steps() == [10, 15, 20]


class _FakeCkptMgr:
    """In-memory checkpoint manager: save/wait/latest_step."""

    def __init__(self):
        self.saved = {}

    def save(self, step, state):
        self.saved[step] = state

    def wait(self):
        pass

    def latest_step(self):
        return max(self.saved) if self.saved else None


def _flaky_step(fail_at, exc):
    fired = []

    def step_fn(state, step):
        if step == fail_at and not fired:
            fired.append(step)
            raise exc
        return state + 1

    return step_fn


def test_supervisor_default_only_recovers_simulated_failure():
    """``tests/test_faults.py:280-297``, first half."""
    sup = Supervisor(_FakeCkptMgr(), ckpt_every=5)
    with pytest.raises(OSError):
        sup.run(0, _flaky_step(7, OSError("flaky fs")), 10,
                restore_fn=lambda s, step: (step or 0, step or 0))
    mgr = _FakeCkptMgr()
    state, report = Supervisor(mgr, ckpt_every=5).run(
        0, _flaky_step(7, SimulatedFailure("node lost")), 10,
        restore_fn=lambda s, step: (mgr.saved[step], step))
    assert (state, report["restarts"], report["failed_steps"]) == (10, 1, [7])


def test_supervisor_recoverable_tuple_widens_restart_trigger():
    """``tests/test_faults.py:280-297``, second half; and the restart
    budget."""
    mgr = _FakeCkptMgr()
    sup = Supervisor(mgr, ckpt_every=5,
                     recoverable=(SimulatedFailure, OSError))
    state, report = sup.run(
        0, _flaky_step(7, OSError("flaky fs")), 10,
        restore_fn=lambda s, step: (mgr.saved[step], step))
    assert report["restarts"] == 1 and report["failed_steps"] == [7]
    assert state == 10  # replayed 5 → 10 after restore

    def always(state, step):
        raise SimulatedFailure("again")

    with pytest.raises(RuntimeError, match="max_restarts=1"):
        Supervisor(_FakeCkptMgr(), max_restarts=1).run(
            0, always, 3, restore_fn=lambda s, step: (0, 0))


# --- the train step ---------------------------------------------------------------------------


def test_make_train_step_matches_reference_over_three_steps():
    jcfg, tcfg = _cfgs()
    opt_kw = dict(lr_peak=3e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt_kw)))
    tstep = tsteps.make_train_step(tcfg, tadamw.AdamWConfig(**opt_kw),
                                   device="cpu")
    jp, tp = _params(jcfg, seed=4)
    jo, to = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for step in range(3):
        jb, tb = _batch(jcfg.vocab, 2, 32, step=step, seed=4)
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        assert set(tm) == set(jm) == {"xent", "loss", "grad_norm", "lr"}
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= GRAD_TOL * float(jm[k])
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= OPT_TOL * float(
            jm["lr"])
    _assert_trees_close(tp, jp, GRAD_TOL, "params after 3 steps")
    _assert_trees_close(to.mu, jo.mu, GRAD_TOL, "mu after 3 steps")
    _assert_trees_close(to.nu, jo.nu, GRAD_TOL, "nu after 3 steps")
    restored = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jo),
                                            device="cpu")
    assert int(restored.step) == 3 and restored.step.dtype == torch.int32
    _assert_trees_close(restored.mu, jo.mu, 0.0, "opt_state_from_numpy")
    with pytest.raises(ValueError, match="this step runs on"):
        tstep(tp, to, {k: v.to("meta") for k, v in tb.items()})


def test_training_reduces_loss_on_markov_data():
    """``tests/test_system.py:33`` on the reduced mamba2: the loss falls
    by more than a nat toward the chain's entropy rate (ln 4 ≈ 1.386;
    untrained ≈ ln 64 ≈ 4.16)."""
    _, cfg = _cfgs(vocab=64)
    ds = tdata.MarkovLMDataset(vocab=64, seq_len=64, branching=4, seed=1)
    params = tssm.init_params(cfg, seed=0, device="cpu")
    opt_cfg = tadamw.AdamWConfig(lr_peak=5e-3, warmup_steps=5,
                                 total_steps=80)
    step = tsteps.make_train_step(cfg, opt_cfg, device="cpu")
    opt = tadamw.adamw_init(params)
    losses = []
    for i in range(80):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch(i, 0, 16).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


# --- the CLI ---------------------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_train_cli_restarts_from_its_checkpoint_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "8", "--global-batch", "2",
         "--seq-len", "32", "--ckpt-every", "3", "--simulate-failure-at",
         "5", "--log-every", "1", "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert "restored at step 3" in out.stderr
    lines = out.stdout.splitlines()
    done = next(line for line in lines if line.startswith("done:"))
    assert "restarts=1" in done and "device=cpu" in done
    logged = [line.split()[:4] for line in lines if line.startswith("step ")]
    # steps 3 and 4 replay after the restore, with the same losses
    assert [s[1] for s in logged] == ["0", "1", "2", "3", "4", "3", "4",
                                      "5", "6", "7"]
    assert logged[3] == logged[5] and logged[4] == logged[6]
    assert np.isfinite(float(done.split("final loss")[1].split()[0]))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.all_steps() == [3, 6, 8]


def test_train_cli_imports_no_jax_and_refuses_a_mesh(tmp_path):
    code = textwrap.dedent(f"""
        import json, sys
        from repro_torch.launch import train
        train.main(["--reduced", "--device", "cpu", "--steps", "2",
                    "--global-batch", "2", "--seq-len", "16",
                    "--ckpt-every", "1", "--ckpt-dir", {str(tmp_path)!r}])
        try:
            train.main(["--reduced", "--device", "cpu", "--mesh", "1x2"])
        except RuntimeError as e:
            assert "one card per rank" in str(e), e
        else:
            raise AssertionError("--mesh 1x2 over nccl on the CPU ran")
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print(json.dumps(bad))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    with pytest.raises(RuntimeError, match="one card per rank"):
        ttrain.main(["--reduced", "--device", "cpu", "--mesh", "2x4"])
