"""The MoE family in the port (``repro_torch.models.moe``, the MoE
transformer, its two configs and its training) against the JAX package:
mixtral-8x7b and qwen3-moe-30b-a3b at the reference's reduced size
(``reduced_config``: 4 layers, d_model 64, 4 heads of 16, 8 experts
top-2 of width 96, vocab 512; mixtral's window 16).

Both packages compute on the same weights: the JAX ``init_params`` tree
(or ``init_moe_params``) crosses through ``convert``; other inputs are
numpy draws from a seed. The reference computes the router, the
dispatch and the experts in plain ``jnp`` (no Pallas kernel), so
nothing here runs in interpret mode.

Tolerances, max |port − ref| / max |ref| unless said: 1e-5 in float32
(the same sums in other orders; the routes, positions and drops are
equal, so the outputs agree to float32 rounding); 2e-2 in bfloat16
where the routes agree (the reference's bf16 tolerance,
``tests/test_kernels.py:125``); the loss within 1e-5 relative and each
gradient leaf within 1e-4 relative L2, as ``tests/test_torch_dense_
train.py`` holds the dense family.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.data import BatchIterator, MarkovLMDataset
from repro_torch.distrib import sharding as shlib
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves_with_path

ROOT = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
MOE = ("qwen3-moe-30b-a3b", "mixtral-8x7b")


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


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want) -> float:
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _flat(tree) -> dict[str, np.ndarray]:
    if isinstance(jax.tree_util.tree_leaves(tree)[0], jax.Array):
        return {"/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v, np.float64)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {"/".join(path): v.detach().double().numpy()
            for path, v in tree_leaves_with_path(tree)}


def _layer(cfg, seed, dtype="float32"):
    """One layer's MoE parameters: (JAX dict, port dict) in ``dtype``."""
    p = jmoe.init_moe_params(cfg, jax.random.PRNGKey(seed), 1)
    p = {k: np.array(v[0]) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p.items()}
    return {k: jnp.asarray(v.float().numpy()).astype(dtype)
            for k, v in tp.items()}, tp


def _x(cfg, b, s, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.standard_normal((b, s, cfg.d_model)).astype(
        np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(dtype), t


# --- router, groups, the FFN ---------------------------------------------------


@pytest.mark.parametrize("ties", (False, True))
def test_router_topk_matches_reference(ties):
    """Gates, choices and probabilities; with ties (integer logits) the
    choices come in ``lax.top_k``'s order: ties to the lower expert."""
    rng = np.random.default_rng(1)
    logits = (rng.integers(0, 3, (3, 10, 8)) if ties
              else rng.standard_normal((3, 10, 8))).astype(np.float32)
    jg, ji, jp = jmoe.router_topk(jnp.asarray(logits), 3)
    tg, ti, tp = tmoe.router_topk(torch.from_numpy(logits), 3)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert _rel(tg, jg) <= TOL["float32"] and _rel(tp, jp) <= TOL["float32"]
    if ties:  # some token has a tie inside its top 3
        assert (np.sort(logits, -1)[..., -3:] == np.sort(
            logits, -1)[..., -4:-1]).any()


@pytest.mark.parametrize("b,s,group_size", (
    (1, 1, 1024), (3, 7, 1024), (2, 1031, 1024), (5, 12, 7), (1, 2048, 1024),
    (4, 1, 3)))
def test_group_matches_reference_over_awkward_token_counts(b, s, group_size):
    """The walk down from ``min(group_size, t)`` to a divisor of t: a
    prime t gives groups of one (2 x 1031 gives 2 groups of 1031)."""
    x = np.arange(b * s * 2, dtype=np.float32).reshape(b, s, 2)
    jx, jtg = jmoe._group(jnp.asarray(x), group_size)
    tx, ttg = tmoe.group(torch.from_numpy(x), group_size)
    assert ttg == jtg and np.array_equal(tx.numpy(), np.asarray(jx))
    assert tmoe.group_size_for(b * s, group_size) == jtg


def _kept_by_count(idx: np.ndarray, E: int, cap: int) -> int:
    """Kept (token, choice) pairs from the choices alone: each group's
    expert keeps min(its count, cap) of them."""
    counts = np.stack([(idx == e).sum(axis=(1, 2)) for e in range(E)], -1)
    return int(np.minimum(counts, cap).sum())


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("capacity_factor,group_size", (
    (1.25, 1024), (0.5, 1024), (0.5, 16)))
def test_moe_ffn_matches_reference(capacity_factor, group_size, dtype):
    """Output and aux at capacity factors 1.25 and 0.5 (one group of 48
    tokens, or three of 16); the routed and kept (token, choice) pairs
    counted by the port equal a count from the reference's choices, and
    at 0.5 pairs are dropped."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", capacity_factor=capacity_factor)
    jp, tp = _layer(jcfg, seed=2, dtype=dtype)
    jx, tx = _x(jcfg, 2, 24, seed=2, dtype=dtype)
    want, jaux = jmoe.moe_ffn(jx, jp, jcfg, group_size=group_size)
    with tmoe.recording(keep_routes=True) as rec:
        got, aux = tmoe.moe_ffn(tx, tp, tcfg, group_size=group_size)
    assert got.dtype == tx.dtype and aux.dtype == torch.float32
    xg, tg = jmoe._group(jx, group_size)
    logits = xg.astype(jnp.float32) @ jp["router"].astype(jnp.float32)
    _, jidx, _ = jmoe.router_topk(logits, jcfg.top_k)
    (idx,) = rec["routes"]
    assert np.array_equal(idx.numpy(), np.asarray(jidx))  # routes agree
    cap = max(int(tg * jcfg.top_k / jcfg.n_experts * capacity_factor), 1)
    assert int(rec["routed"]) == 2 * 24 * jcfg.top_k
    assert int(rec["kept"]) == _kept_by_count(np.asarray(jidx),
                                              jcfg.n_experts, cap)
    if capacity_factor < 1:
        assert int(rec["kept"]) < int(rec["routed"])
    assert _rel(got, want) <= TOL[dtype]
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_moe_ffn_drops_change_the_output():
    """The capacity cut matters: at 0.5 the output differs from 1.25's
    on the tokens that lost a choice."""
    _, lo = _cfgs("qwen3-moe-30b-a3b", capacity_factor=0.5)
    hi = dataclasses.replace(lo, capacity_factor=4.0)
    _, tp = _layer(lo, seed=3)
    _, tx = _x(lo, 2, 24, seed=3)
    a, _ = tmoe.moe_ffn(tx, tp, lo)
    b, _ = tmoe.moe_ffn(tx, tp, hi)
    assert float((a - b).abs().max()) > 1e-2


# --- the model: configs, forward, loss, gradients, decode ----------------------


@pytest.mark.parametrize("arch", MOE)
def test_moe_params_have_the_reference_shapes(arch):
    """The full config's abstract tree (the nested ``blocks/moe`` leaves)
    against the reference's, and the reduced init's leaves and dtypes;
    ``cast_params`` casts the router with the experts."""
    want = jspecs.abstract_params(jreg.get_config(arch))
    got = ttr.abstract_params(treg.get_config(arch))
    flat = {"/".join(p): tuple(v.shape)
            for p, v in tree_leaves_with_path(got)}
    assert flat == {"/".join(str(k.key) for k in path): tuple(v.shape)
                    for path, v in jax.tree_util.tree_flatten_with_path(
                        want)[0]}
    assert "blocks/moe/router" in flat and "blocks/w_gate" not in flat
    _, tcfg = _cfgs(arch)
    params = ttr.init_params(tcfg, seed=0, device="cpu")
    assert params["blocks"]["moe"]["w_down"].shape == (4, 8, 96, 64)
    assert float(params["blocks"]["moe"]["router"].std()) > 0.05
    cast = ttr.cast_params(params["blocks"], "bfloat16")
    assert cast["moe"]["router"].dtype == torch.bfloat16
    assert cast["ln1"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_reference(arch, dtype, monkeypatch):
    """Logits and the aux summed over the layers; a (2, 24) batch. In
    bfloat16 the reference runs op by op (``analysis_unroll``, no jit):
    under jit XLA on the CPU fuses the bf16 ops and keeps their
    intermediates in float32, which moves a router logit across a
    near-tie and flips a route; op by op each result is rounded where
    the code rounds it, as PyTorch rounds it, and every layer's routes
    must agree with the port's."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp, tp = _params(jcfg, seed=1)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 24))
    jroutes = []
    if dtype == "bfloat16":
        plain = jmoe.router_topk

        def recorded(logits, k):
            out = plain(logits, k)
            jroutes.append(np.asarray(out[1]))
            return out

        monkeypatch.setattr(jmoe, "router_topk", recorded)
        want, jaux = jtr.forward(
            jp, dataclasses.replace(jcfg, analysis_unroll=True),
            jnp.asarray(tokens))
    else:
        want, jaux = jax.jit(jtr.forward, static_argnums=1)(
            jp, jcfg, jnp.asarray(tokens))
    with tmoe.recording(keep_routes=True) as rec:
        got, aux = ttr.forward(tp, tcfg, torch.from_numpy(tokens))
    assert len(rec["routes"]) == tcfg.n_layers
    for mine, theirs in zip(rec["routes"], jroutes, strict=False):
        assert np.array_equal(mine.numpy(), theirs)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) <= TOL[dtype]
    assert abs(float(aux) - float(jaux)) <= TOL[dtype] * float(jaux)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE)
def test_lm_loss_and_every_gradient_leaf_match_reference(arch):
    """The loss with the router's weighted aux, its metrics, and every
    gradient leaf (the router's and the experts' included) against
    ``jax.value_and_grad``."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=2)
    nb = MarkovLMDataset(jcfg.vocab, 32, seed=2).batch(0, 0, 2)
    (want, want_m), want_grads = jax.jit(
        jax.value_and_grad(jtr.lm_loss, has_aux=True), static_argnums=1,
    )(jp, jcfg, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, metrics, grads = tsteps.make_grad_step(tcfg, device="cpu")(
        tp, {k: torch.from_numpy(v) for k, v in nb.items()})
    assert abs(float(loss) - float(want)) <= LOSS_TOL * float(want)
    for k in ("xent", "aux"):
        assert abs(float(metrics[k]) - float(want_m[k])) <= \
            LOSS_TOL * float(want_m[k]), k
    got, ref = _flat(grads), _flat(want_grads)
    assert set(got) == set(ref)
    worst = {k: _rel_l2(got[k], ref[k]) for k in ref}
    assert max(worst.values()) <= GRAD_TOL, worst
    assert np.abs(got["blocks/moe/router"]).max() > 0


@pytest.mark.parametrize("arch,steps,max_len", (
    ("qwen3-moe-30b-a3b", 12, 16), ("mixtral-8x7b", 22, 32)))
def test_decode_step_matches_reference(arch, steps, max_len):
    """Decode step by step (logits and both caches) against the JAX
    ``decode_step``. Each step's FFN groups only the batch's new tokens
    (capacity 1 per expert), as the reference's does. mixtral's reduced
    window of 16 makes a ring of 16 slots, overwritten from step 17."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=3)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (2, steps))
    jstep = jax.jit(jtr.decode_step, static_argnums=1)
    jcache = jtr.init_decode_cache(jcfg, 2, max_len)
    tcache = ttr.init_decode_cache(tcfg, 2, max_len, device="cpu")
    assert tcache.k.shape == jcache.k.shape
    if arch == "mixtral-8x7b":
        assert tcache.k.shape[2] == 16 < steps
    for i in range(steps):
        jl_, jcache = jstep(jp, jcfg, jnp.asarray(tokens[:, i:i + 1]), jcache)
        tl_, tcache = ttr.decode_step(
            tp, tcfg, torch.from_numpy(tokens[:, i:i + 1]), tcache)
        assert _rel(tl_, jl_) <= TOL["float32"], i
        assert _rel(tcache.k, jcache.k) <= TOL["float32"], i
        assert _rel(tcache.v, jcache.v) <= TOL["float32"], i


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_qk_norm_matches_reference(dtype):
    """qwen3-moe's per-head RMS norm of q and k (random gains, so the
    norm is not the identity) against the reference's ``_qkv``."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", dtype=dtype)
    assert tcfg.qk_norm
    rng = np.random.default_rng(4)
    d, hd = tcfg.d_model, tcfg.hd
    blk = {"wq": rng.standard_normal((d, tcfg.n_heads * hd)) / 8,
           "wk": rng.standard_normal((d, tcfg.n_kv_heads * hd)) / 8,
           "wv": rng.standard_normal((d, tcfg.n_kv_heads * hd)) / 8,
           "q_norm": rng.standard_normal(hd),
           "k_norm": rng.standard_normal(hd)}
    dt = getattr(torch, dtype)
    tblk = {k: torch.from_numpy(v.astype(np.float32)).to(
        torch.float32 if k.endswith("norm") else dt) for k, v in blk.items()}
    jblk = {k: jnp.asarray(v.float().numpy()).astype(
        "float32" if k.endswith("norm") else dtype) for k, v in tblk.items()}
    jx, tx = _x(tcfg, 2, 6, seed=4, dtype=dtype)
    got = ttr._qkv(tx, tblk, tcfg)
    want = jtr._qkv(jx, jblk, jcfg)
    for g, w in zip(got, want):
        assert g.dtype == dt
        assert _rel(g, w) <= TOL[dtype]
    plain = ttr._qkv(tx, tblk, dataclasses.replace(tcfg, qk_norm=False))
    assert _rel(plain[0], want[0]) > 10 * TOL[dtype]


def test_remat_gives_the_same_loss_and_gradients():
    """Selective remat recomputes each MoE layer (the router's ``mm``
    kept, the batched dispatch and expert einsums recomputed): the same
    arithmetic, so the same bits."""
    _, plain_cfg = _cfgs("mixtral-8x7b")
    remat_cfg = dataclasses.replace(plain_cfg, remat="selective")
    tp = ttr.init_params(plain_cfg, seed=5, device="cpu")
    nb = MarkovLMDataset(plain_cfg.vocab, 32, seed=5).batch(0, 0, 2)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    (l0, _, g0), (l1, _, g1) = (
        tsteps.make_grad_step(c, device="cpu")(tp, tb)
        for c in (plain_cfg, remat_cfg))
    assert float(l0) == float(l1)
    for (path, a), (_, b) in zip(tree_leaves_with_path(g1),
                                 tree_leaves_with_path(g0), strict=True):
        assert torch.equal(a, b), path


def test_groups_spanning_data_ranks_gather_and_whole_groups_run():
    """Groups that span data ranks are gathered: on two gloo CPU ranks
    (``launch.mesh.run_on_mesh``, mesh (2, 1)), (1, 16) tokens a rank
    (a global group of 32) under the tp profile (the batch over
    ``data``) and the dp profile (over ``data`` x ``model``) give each
    rank the one-rank forward's logits of its row of the global batch,
    and route the whole group as it does. Under a rule set of axis
    sizes alone, (1, 1024) tokens (global groups of 1024) give the
    one-rank forward of those rows bit for bit."""
    import _torch_tp_cases as cases
    from repro_torch.launch.mesh import run_on_mesh

    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b", n_layers=1)
    jp, params = _params(jcfg, seed=6)
    tokens = torch.randint(0, cfg.vocab, (2, 1024),
                           generator=torch.Generator().manual_seed(6))
    span = tokens[:, :16].numpy()
    ranks = run_on_mesh(cases.span_rank, (2, 1), cases.AXES,
                        backend="gloo", device="cpu", timeout=300,
                        args=("qwen3-moe-30b-a3b", {"n_layers": 1},
                              jax.tree.map(np.asarray, jp), span))
    with torch.no_grad():
        one = []
        routes = cases.moe_routes(lambda: one.append(
            ttr.forward(params, cfg, torch.from_numpy(span))[0]))
    for rank, r in enumerate(ranks):
        for profile in ("tp", "dp"):
            n, logits, got = r[profile]
            assert n == 2
            assert _rel(logits, one[0][rank:rank + 1]) <= TOL["float32"]
            assert (got["routed"], got["kept"]) == (routes["routed"],
                                                    routes["kept"])
            np.testing.assert_array_equal(got["routes"][0],
                                          routes["routes"][0])
            assert got["routes"][0].shape == (1, 32, 2)
    for sizes, profile in (({"data": 2, "model": 1}, "tp"),
                           ({"data": 1, "model": 2}, "dp")):
        rules = shlib.profile_act_rules(profile)
        with shlib.rules_context(sizes, rules), torch.no_grad():
            cut, _ = ttr.forward(params, cfg, tokens[:1])
        with torch.no_grad():
            whole, _ = ttr.forward(params, cfg, tokens[:1])
        assert torch.equal(cut, whole)
    assert shlib.batch_ranks() == 1


def test_batch_left_whole_by_batch_spec_is_not_counted_as_cut():
    """Reduced mixtral, tokens (1, 512) under the tp profile on {data: 2,
    model: 1}: ``batch_spec`` leaves the one row whole, so the ranks
    that cut the batch are 1 (declared rows or not) and the forward is
    the one without a rule set, groups of 512 tokens, not of 1024
    spanning both data ranks. A declared batch of 2 rows is cut over
    both."""
    _, cfg = _cfgs("mixtral-8x7b")
    params = ttr.init_params(cfg, seed=8, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 512),
                           generator=torch.Generator().manual_seed(8))
    sizes, rules = {"data": 2, "model": 1}, shlib.profile_act_rules("tp")
    assert shlib.batch_spec("tokens", (1, 512), sizes) == ()
    with torch.no_grad():
        want, _ = ttr.forward(params, cfg, tokens)
    for rows in (None, 1):
        with shlib.rules_context(sizes, rules, batch_rows=rows):
            assert shlib.batch_ranks() == 1
            with torch.no_grad():
                got, _ = ttr.forward(params, cfg, tokens)
        assert torch.equal(got, want)
    with shlib.rules_context(sizes, rules, batch_rows=2):
        cut = shlib.batch_cut()
        assert (cut.axes, cut.ranks, cut.group) == (("data",), 2, None)
        with pytest.raises(ValueError, match="no process group"):
            ttr.forward(params, cfg, tokens)


def test_moe_steps_on_a_model_axis_pass_the_tp_refusal():
    """The tp profile now has a form for every MoE leaf: ``train_
    shardings`` cuts the experts over ``model`` (EP) when E divides it,
    else their hidden width (expert-TP), and keeps the router whole."""
    _, cfg = _cfgs("qwen3-moe-30b-a3b")
    specs = {}
    for m in (2, 4, 16):
        p_sh, _ = tsteps.train_shardings(cfg, {"data": 1, "model": m})
        specs[m] = {"/".join(p): sh.spec for p, sh in
                    tree_leaves_with_path(p_sh)}
    assert specs[2]["blocks/moe/w_gate"] == (None, "model")
    assert specs[2]["blocks/moe/w_down"] == (None, "model")
    assert specs[16]["blocks/moe/w_gate"] == (None, None, None, "model")
    assert specs[16]["blocks/moe/w_down"] == (None, None, "model")
    assert specs[4]["blocks/moe/router"] == ()


def test_a_port_moe_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    """The nested ``blocks/moe/*`` leaves and their AdamW moments keep
    the reference's path spelling: a port checkpoint of reduced mixtral
    restores in the JAX package bit for bit, and back in the port."""
    from repro.checkpoint import manager as jmanager
    from repro.optim import adamw as jadamw
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.tree import tree_map

    jcfg, _ = _cfgs("mixtral-8x7b", n_layers=2)
    jp, tp = _params(jcfg, seed=7)
    state = {"params": tp, "opt": adamw_init(tp)}
    CheckpointManager(str(tmp_path)).save(3, state, blocking=True)
    target = jax.tree.map(jnp.zeros_like,
                          {"params": jp, "opt": jadamw.adamw_init(jp)})
    restored, step = jmanager.CheckpointManager(str(tmp_path)).restore(
        target)
    assert step == 3
    got = {jmanager._path_str(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(restored)[0]}
    want = _flat(state)
    assert "params/blocks/moe/w_down" in want and set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    again, _ = CheckpointManager(str(tmp_path)).restore(
        tree_map(torch.zeros_like, state))
    assert all(np.array_equal(v, want[k]) for k, v in _flat(again).items())


def test_train_cli_logs_make_train_steps_losses(tmp_path):
    """The train CLI on ``--arch qwen3-moe-30b-a3b --reduced``: its
    logged losses equal ``make_train_step``'s on the seeded init and the
    CLI's Markov batches."""
    args = ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device", "cpu",
            "--steps", "4", "--global-batch", "2", "--seq-len", "32",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    logged = [line.split()[3] for line in proc.stdout.splitlines()
              if line.startswith("step ")]
    assert "arch=qwen3-moe-30b-a3b" in proc.stdout
    cfg = treg.reduced_config(treg.get_config("qwen3-moe-30b-a3b"))
    step = tsteps.make_train_step(
        cfg, AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=4),
        device="cpu")
    params = ttr.init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(params)
    data = MarkovLMDataset(vocab=cfg.vocab, seq_len=32, branching=4)
    want = []
    for i in range(4):
        batch = BatchIterator(data, 2, start_step=i).next_global(
            torch.device("cpu"))
        params, opt, m = step(params, opt, batch)
        assert set(m) == {"xent", "aux", "loss", "grad_norm", "lr"}
        want.append(f"{float(m['loss']):.4f}")
    assert logged == want
