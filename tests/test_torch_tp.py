"""The port's tensor parallelism (the ``tp`` profile's ``model`` axis)
against the JAX package's GSPMD steps on the same meshes, and against
the port's own one-rank steps.

Every family's reduced configs (d_model 64, vocab 512, float32; fields
replaced per case, ``tests/_torch_tp_cases.py`` says which rule each
reaches: the MoE's experts over ``model`` (EP) on (1, 2), their hidden
width (expert-TP) on (1, 4), and on (2, 2) and (2, 1) groups that
span the data ranks, gathered over them; mamba2's ``in_proj`` cut inside xBC on
(1, 2), inside z on (1, 4), with fsdp on (2, 2); recurrentgemma's
vocab-parallel embedding and width-cut cache on (1, 2) and (2, 2);
whisper's embedding cut at vocab 512 on (1, 2) and whole at 513 on
(1, 4), its batches carrying ``frames``) from the reference's ``init_params``
(carried across with ``convert``), a Markov batch of 4 x 16 tokens. On
meshes (1, 2), (1, 4), (2, 2) and (2, 1) of ``("data", "model")``: the port's
ranks are CPU processes over gloo, spawned by ``launch.mesh.
run_on_mesh`` once per mesh for the whole module, all at once;
the reference's ``jit_prefill_step``, ``jit_serve_step`` (with
``cache_shardings``) and ``jit_train_step`` run under ``rules_context``
on the same mesh shapes of 8 XLA host devices.

Each serve case runs the prefill and 8 decode steps from an empty cache
of 8 slots (a length every model axis here divides; whisper's cache is
``init_decode_cache`` of the encoder's output, its cross K/V included);
each train case one step. Tolerances:
* f32 logits within 1e-5 of the reference's max |logit| (the row
  parallel products sum their partial sums in another order);
* the loss, the gradient norm and every gathered gradient leaf within
  1e-4 relative (L2 per leaf) of the reference's, the training
  tolerance of ``tests/test_torch_dp_train.py``;
* against the port's one-rank step, 1e-5;
* the parameters after the step as ``tests/test_torch_dp_train.py``
  holds them (an element whose gradient is a near-cancellation, below
  ``SMALL_GRAD`` of its leaf's RMS, may take Adam's step of either sign:
  within 2·lr).

The reference's cache rule cuts by sequence only where the batch is cut
over a data axis above one rank, so the (1, M) meshes hold the cache by
heads or whole and the (2, 2) mesh's gemma-2b case cuts it by sequence.
"""
import dataclasses
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import _torch_tp_cases as cases  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.distrib import sharding as jshlib  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import (  # noqa: E402
    get_config,
    get_model,
    reduced_config,
)
from repro_torch.data import MarkovLMDataset  # noqa: E402
from repro_torch.distrib import sharding as shlib  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import run_on_mesh  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LOGIT_TOL = 1e-5
REF_TOL = 1e-4
ONE_RANK_TOL = 1e-5
SMALL_GRAD = 3e-3
CASES = [(shape, name) for shape, named in cases.MESHES.items()
         for name in named]
SERVE = [c for c in CASES if "serve" in cases.MESHES[c[0]][c[1]][2]]
TRAIN = [c for c in CASES if "train" in cases.MESHES[c[0]][c[1]][2]]


@pytest.fixture(autouse=True)
def _f32_reference():
    with jax.enable_x64(False):
        yield


def _inputs(shape, name, seed):
    """(reference config, its parameters, the numpy batch)."""
    arch, fields, _, _ = cases.MESHES[shape][name]
    jcfg = dataclasses.replace(jreg.reduced_config(jreg.get_config(arch)),
                               **fields)
    params = jreg.get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    seed = cases.SEEDS.get(name, seed)
    batch = MarkovLMDataset(jcfg.vocab, cases.SEQ, seed=seed).batch(
        0, 0, cases.BATCH)
    mask = cases.loss_mask(name)
    if mask is not None:
        batch["loss_mask"] = mask
    if jcfg.is_encdec:
        batch["frames"] = np.random.default_rng(seed).standard_normal(
            (cases.BATCH, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "vlm":
        rng = np.random.default_rng(seed)
        t = np.broadcast_to(np.arange(cases.SEQ), (cases.BATCH, cases.SEQ))
        batch["positions"] = np.stack([t, t // 4, t % 4]).astype(np.int32)
        batch["patch_embeds"] = rng.standard_normal(
            (cases.BATCH, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
    return jcfg, params, batch


def _flat(tree):
    if isinstance(jax.tree_util.tree_leaves(tree)[0], jax.Array):
        return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in path): np.asarray(v, np.float64)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return cases.flat(tree)


def _abstract(tree):
    return {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in tree.items()}


def _cache_leaves(cache) -> dict:
    return {k: v for k, v in cache._asdict().items() if k != "length"}


def _reference_cache(jcfg, jparams, frames):
    """The reference's empty decode cache of ``cases.BATCH`` rows and
    ``cases.MAX_LEN`` slots (whisper's from the encoder's output)."""
    if jcfg.is_encdec:
        return jenc.init_decode_cache(
            jparams, jcfg, jenc.encode(jparams, jcfg, frames))
    return jreg.get_model(jcfg).init_decode_cache(jcfg, cases.BATCH,
                                                  cases.MAX_LEN)


def _reference(shape, name, jcfg, jparams, batch):
    """The reference's jitted steps on ``shape``: the prefill's logits,
    8 decode steps' logits and last cache, one train step's metrics and
    parameters; and ``jax.value_and_grad`` of ``lm_loss``."""
    _, _, parts, fsdp = cases.MESHES[shape][name]
    devices = np.array(jax.devices()[:int(np.prod(shape))])
    mesh = Mesh(devices.reshape(shape), cases.AXES)
    train = {k: jnp.asarray(v) for k, v in batch.items()}
    prompt = {k: v for k, v in train.items() if k != "labels"}
    rec = {}
    with jshlib.rules_context(mesh, jshlib.profile_act_rules("tp")):
        if "serve" in parts:
            fn, (p_sh, b_sh) = jsteps.jit_prefill_step(jcfg, mesh,
                                                       _abstract(prompt))
            rec["prefill"] = np.asarray(fn(
                jax.device_put(jparams, p_sh),
                {k: jax.device_put(v, b_sh[k]) for k, v in prompt.items()}))
            cache = _reference_cache(jcfg, jparams, train.get("frames"))
            tok_abs = {"tokens": jax.ShapeDtypeStruct((cases.BATCH, 1),
                                                      jnp.int32)}
            fn, (p_sh, c_sh, b_sh) = jsteps.jit_serve_step(
                jcfg, mesh, tok_abs, jax.tree.map(
                    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), cache),
                donate_cache=False)
            rec["cache_spec"] = {k: tuple(v.spec) for k, v in
                                 _cache_leaves(c_sh).items()}
            params, cache = (jax.device_put(jparams, p_sh),
                             jax.device_put(cache, c_sh))
            logits = []
            for t in range(cases.DECODE_STEPS):
                tok = jax.device_put(train["tokens"][:, t:t + 1],
                                     b_sh["tokens"])
                lg, cache = fn(params, cache, {"tokens": tok})
                logits.append(np.asarray(lg))
            rec["decode"] = np.stack(logits, 1)
            rec["cache"] = {k: np.asarray(v, np.float64)
                            for k, v in _cache_leaves(cache).items()}
        if "train" in parts:
            fn, (p_sh, o_sh, b_sh) = jsteps.jit_train_step(
                jcfg, mesh, _abstract(train), fsdp=fsdp,
                opt_cfg=jadamw.AdamWConfig(**cases.OPT), donate=False)
            params = jax.device_put(jparams, p_sh)
            opt = jax.device_put(jadamw.adamw_init(params), o_sh)
            params, _, m = fn(params, opt, {k: jax.device_put(v, b_sh[k])
                                            for k, v in train.items()})
            rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       lr=float(m["lr"]), params=_flat(params))
    if "train" in parts:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            jreg.get_model(jcfg).lm_loss, has_aux=True),
            static_argnums=1)(jparams, jcfg, train)
        rec.update(loss0=float(loss), grads=_flat(grads))
    return rec


def _one_rank(shape, name, params_np, batch):
    """The port's steps without a mesh on the same inputs."""
    arch, fields, parts, _ = cases.MESHES[shape][name]
    cfg = cases.config(arch, fields)
    params = convert.model_params_from_numpy(params_np, device="cpu")
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    rec = {}
    with torch.no_grad():
        if "serve" in parts:
            prompt = {k: v for k, v in tb.items() if k != "labels"}
            prefill = tsteps.make_prefill_step(cfg, device="cpu")
            routes = cases.moe_routes(lambda: rec.update(
                prefill=prefill(params, prompt).numpy()))
            if cfg.family == "moe":
                rec["prefill_routes"] = routes
            serve = tsteps.make_serve_step(cfg, device="cpu")
            cache = cases.new_cache(cfg, params, tb.get("frames"))
            logits = []
            for t in range(cases.DECODE_STEPS):
                lg, cache = serve(params, cache,
                                  {"tokens": tb["tokens"][:, t:t + 1]})
                logits.append(lg)
            rec["decode"] = torch.stack(logits, 1).numpy()
    if "train" in parts:
        loss, _, grads = tsteps.make_grad_step(cfg, device="cpu")(params, tb)
        rec.update(loss0=float(loss), grads=cases.flat(grads))
        step = tsteps.make_train_step(cfg, AdamWConfig(**cases.OPT),
                                      device="cpu")
        params, _, m = step(params, adamw_init(params), tb)
        rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   params=cases.flat(params))
    return rec


@pytest.fixture(scope="module")
def results():
    """{(shape, case): (every rank's results, the one-rank port's, the
    reference's)}: the three meshes' ranks spawned at once in the
    background while this process runs the reference and the one-rank
    steps."""
    with jax.enable_x64(False):
        inputs = {(shape, name): _inputs(shape, name, seed)
                  for seed, (shape, name) in enumerate(CASES)}
        threads = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            with ThreadPoolExecutor(len(cases.MESHES)) as pool:
                jobs = {shape: pool.submit(
                    run_on_mesh, cases.tp_rank, shape, cases.AXES,
                    backend="gloo", device="cpu", timeout=600,
                    args=(named, {name: (jax.tree.map(np.asarray,
                                                      inputs[shape, name][1]),
                                         inputs[shape, name][2])
                                  for name in named}))
                        for shape, named in cases.MESHES.items()}
                out = {}
                for (shape, name), (jcfg, jp, batch) in inputs.items():
                    out[shape, name] = (
                        None, _one_rank(shape, name,
                                        jax.tree.map(np.asarray, jp), batch),
                        _reference(shape, name, jcfg, jp, batch))
                ranks = {shape: job.result() for shape, job in jobs.items()}
        finally:
            torch.set_num_threads(threads)
    return {key: ([r[key[1]] for r in ranks[key[0]]],) + rest[1:]
            for key, rest in out.items()}


def _rows(shape, rank: int, x):
    """Rank ``rank``'s rows of a (b, ...) array on a (data, model) mesh."""
    per = cases.BATCH // shape[0]
    lo = (rank // shape[1]) * per
    return x[lo:lo + per]


def _close_logits(got, want, tol, what):
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= tol, (what, err)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _close_trees(got, want, tol, what):
    assert set(got) == set(want), (sorted(got), sorted(want))
    worst = {k: _rel(got[k], want[k]) for k in want}
    assert max(worst.values()) <= tol, (what, worst)


def _close_params(got, want, grads0, tol, what):
    worst, loose = {}, {}
    for k in want:
        g = grads0[k]
        fixed = ((np.abs(g) > SMALL_GRAD * np.sqrt(np.mean(np.square(g))))
                 | (g == 0))
        worst[k] = _rel(got[k][fixed], want[k][fixed])
        if not fixed.all():
            loose[k] = float(np.abs(got[k] - want[k])[~fixed].max())
    assert max(worst.values()) <= tol, (what, worst)
    assert max(loose.values(), default=0.0) <= 2 * cases.OPT["lr_peak"], (
        what, loose)


@pytest.mark.parametrize("shape,name", SERVE)
def test_prefill_matches_reference_and_one_rank(results, shape, name):
    ranks, one, ref = results[shape, name]
    vocab = cases.config(*cases.MESHES[shape][name][:2]).vocab
    for rank, r in enumerate(ranks):
        assert r["prefill"].shape == (cases.BATCH // shape[0], vocab)
        _close_logits(r["prefill"], _rows(shape, rank, ref["prefill"]),
                      LOGIT_TOL, "prefill vs jit_prefill_step")
        _close_logits(r["prefill"], _rows(shape, rank, one["prefill"]),
                      ONE_RANK_TOL, "prefill vs one rank")


@pytest.mark.parametrize("shape,name", SERVE)
def test_decode_matches_reference_and_one_rank(results, shape, name):
    """8 decode steps' logits on every rank, and every leaf of the cache
    after them gathered whole, against ``jit_serve_step``'s."""
    ranks, one, ref = results[shape, name]
    for rank, r in enumerate(ranks):
        assert r["length"] == cases.DECODE_STEPS
        _close_logits(r["decode"], _rows(shape, rank, ref["decode"]),
                      LOGIT_TOL, "decode vs jit_serve_step")
        _close_logits(r["decode"], _rows(shape, rank, one["decode"]),
                      ONE_RANK_TOL, "decode vs one rank")
        assert set(r["cache"]) == set(ref["cache"])
        for k, want in ref["cache"].items():
            assert _rel(r["cache"][k], want) <= LOGIT_TOL, k


@pytest.mark.parametrize("shape,name", SERVE)
def test_decode_cache_block_is_cache_shardings(results, shape, name):
    """Each rank's cache is its block under the reference's
    ``cache_shardings`` spec, leaf by leaf: a transformer's KV cache by
    KV heads, else by sequence (its ``slots`` then its global
    positions); mamba2's conv window by channels and state by heads;
    the hybrid's RG-LRU state and conv window by width, its one-head KV
    ring whole; whisper's self and cross K/V by heads; the batch over
    data."""
    ranks, _, ref = results[shape, name]
    arch, _, _, _ = cases.MESHES[shape][name]
    sizes = dict(zip(cases.AXES, shape))
    data = "data" if shape[0] > 1 else None
    heads = (None, data, None, "model")
    family = {
        "mamba2-780m": {"conv": (None, data, None, "model"),
                        "state": (None, data, "model")},
        "recurrentgemma-9b": {"lru_h": (None, data, "model"),
                              "conv": (None, data, None, "model"),
                              "k": (None, data), "v": (None, data)},
        "whisper-small": dict.fromkeys(("k", "v", "xk", "xv"), heads),
    }
    kv = {"gemma-2b-seq": (None, "data", "model"),
          "mixtral-span": (None, "data", "model"),
          "mixtral-dp": (None, "data"),
          "llama3-8b-kv2": (None, None, None, "model")}.get(name, ())
    want = family.get(arch, {"k": kv, "v": kv})
    strip = {k: tuple(v[:max([i + 1 for i, a in enumerate(v) if a] or [0])])
             for k, v in want.items()}
    assert ref["cache_spec"] == strip
    for rank, r in enumerate(ranks):
        assert {k: tuple(v) for k, v in r["cache_spec"].items()} == strip
        for k, spec in strip.items():
            block = list(ref["cache"][k].shape)
            for d, axis in enumerate(spec):
                if axis is not None:
                    block[d] //= sizes[axis]
            assert r["cache_block"][k] == tuple(block), k
        spec = strip["k"] if "k" in strip and arch not in family else ()
        if len(spec) > 2 and spec[2] == "model":
            lo = (rank % shape[1]) * r["cache_block"]["k"][2]
            assert r["slots"] == list(range(lo, lo + r["cache_block"]["k"][2]))
        else:
            assert r["slots"] is None


@pytest.mark.parametrize("shape,name", TRAIN)
def test_train_step_matches_reference_and_one_rank(results, shape, name):
    """Step 0's loss and synced gradient (every leaf gathered whole)
    against ``jax.value_and_grad`` and the one-rank gradient; after one
    AdamW step the loss, the global gradient norm and the parameters
    against ``jit_train_step``'s on the same mesh and the one-rank
    step's."""
    ranks, one, ref = results[shape, name]
    r = ranks[0]
    for want, tol in ((ref, REF_TOL), (one, ONE_RANK_TOL)):
        for k in ("loss0", "loss", "grad_norm"):
            assert abs(r[k] - want[k]) <= tol * abs(want[k]), (k, r[k],
                                                                want[k])
        _close_trees(r["grads"], want["grads"], tol, "step-0 gradient")
        _close_params(r["params"], want["params"], ref["grads"], tol,
                      "parameters after one step")
    for other in ranks[1:]:
        assert other["loss"] == r["loss"]
        assert other["grad_norm"] == r["grad_norm"]


@pytest.mark.parametrize("shape,name", TRAIN)
def test_every_rank_holds_its_blocks(results, shape, name):
    """Each rank holds its blocks of the leaves ``param_spec`` cuts (the
    heads' projections, the FFN and the vocab over ``model``; mamba2's
    ``in_proj`` columns and conv taps; the hybrid's embeddings only;
    whisper's MLP and, where the vocab divides, its embedding; under
    fsdp also over ``data``) and the norms whole."""
    ranks, _, _ = results[shape, name]
    arch, fields, _, fsdp = cases.MESHES[shape][name]
    cfg = cases.config(arch, fields)
    full = {"/".join(p): tuple(v.shape) for p, v in
            tree_leaves_with_path(get_model(cfg).abstract_params(cfg))}
    m = shape[1]
    sizes = dict(zip(cases.AXES, shape))
    for r in ranks:
        held = r["shard_shapes"]
        for path, want in full.items():
            spec = shlib.param_spec(path, want, sizes, fsdp=fsdp)
            assert held[path] == shlib.block_shape(want, spec, sizes), path
        if cfg.family == "ssm":
            assert held["blocks/in_proj"][2] == full["blocks/in_proj"][2] // m
            assert held["blocks/conv_w"][1] == cfg.ssm_conv_kernel // m
            assert held["blocks/out_proj"][1] == cfg.d_inner // m
        elif cfg.family == "hybrid":
            assert held["unembed"][0] == cfg.d_model // m
            assert all(held[k] == v for k, v in full.items()
                       if k.startswith(("super/", "tail_rec/")))
        elif cfg.family == "audio":
            assert held["blocks/w_in"][2] == cfg.d_ff // m
            assert held["enc_blocks/w_out"][1] == cfg.d_ff // m
            assert held["blocks/attn/wq"] == full["blocks/attn/wq"]
            assert held["embed"][0] == (cfg.vocab // m if cfg.vocab % m == 0
                                        else cfg.vocab)
        elif cfg.family == "moe":  # EP where E splits, else expert-TP
            ep = cfg.n_experts % m == 0
            assert held["blocks/moe/w_gate"][1] == (
                cfg.n_experts // m if ep else cfg.n_experts)
            assert held["blocks/moe/w_down"][2] == (
                cfg.d_ff_expert if ep else cfg.d_ff_expert // m)
            assert held["blocks/moe/router"] == full["blocks/moe/router"]
        else:
            assert held["blocks/w_gate"][2] == cfg.d_ff // m
        norm = {"hybrid": "super/rec1/ln", "audio": "blocks/ln1_w"}.get(
            cfg.family, "blocks/ln1")
        assert held[norm] == full[norm]


def test_tp_plan_answers_each_leafs_cut():
    """``leaf_cut`` reads ``param_spec``'s tp cut under an installed mesh
    (sizes suffice): reduced qwen2.5-3b on 2 ranks cuts wq on head
    boundaries and wk mid-head, w_down by rows, embed by vocab; with
    head_dim 18 on 4, wk is whole; the cache spec follows the
    reference's rule."""
    cfg = cases.config("qwen2.5-3b", {})
    shapes = {"/".join(p): tuple(v.shape) for p, v in
              tree_leaves_with_path(get_model(cfg).abstract_params(cfg))}
    with shlib.rules_context({"data": 1, "model": 2}):
        cut = {k: shlib.leaf_cut(k, s, cfg.hd) for k, s in shapes.items()}
    assert cut["blocks/wq"] == shlib.LeafCut(2, True)
    assert cut["blocks/wk"] == shlib.LeafCut(2, False)
    assert cut["blocks/bk"] == shlib.LeafCut(1, False)
    assert cut["blocks/wo"] == shlib.LeafCut(1, True)
    assert cut["embed"].dim == 0 and cut["blocks/ln1"].dim is None
    with shlib.rules_context({"data": 1, "model": 4}):
        wk = shlib.leaf_cut("blocks/wk", (4, 64, 18), 18)
    assert wk == shlib.LeafCut(None, True)
    kv = (4, 4, 8, 1, 16)
    assert shlib.kv_cache_spec(kv, {"data": 1, "model": 2}) == ()
    assert shlib.kv_cache_spec(kv, {"data": 2, "model": 2}) == (
        None, "data", "model")
    assert shlib.kv_cache_spec((4, 4, 8, 2, 16), {"data": 1, "model": 2}) == (
        None, None, None, "model")
    # the MoE leaves, keyed by their path under blocks (moe/w_gate is not
    # the dense w_gate): experts cut on dim 1 (EP) where E splits, else
    # the hidden width (expert-TP), the router whole
    moe = cases.config("qwen3-moe-30b-a3b", {})
    for sizes, dims in (({"data": 1, "model": 2}, (1, 1, 1)),
                        ({"data": 1, "model": 16}, (3, 3, 2)),
                        ({"data": 1, "model": 5}, (None, None, None))):
        with shlib.rules_context(sizes):
            cut = {k.removeprefix("blocks/moe/"): shlib.leaf_cut(k, s)
                   for k, s in (("/".join(p), tuple(v.shape)) for p, v in
                                tree_leaves_with_path(
                                    get_model(moe).abstract_params(moe)))
                   if k.startswith("blocks/moe/")}
        assert cut["router"] == shlib.LeafCut(None, True)
        assert tuple(cut[k].dim for k in ("w_gate", "w_up", "w_down")) == dims


def test_groups_spanning_data_ranks_route_as_gspmd(results):
    """mixtral on (2, 2): the batch's 4 rows over 2 data ranks, so each
    of GSPMD's MoE groups (the global 64 tokens at prefill and in
    training, the 4 new tokens at decode) spans both data ranks. Every
    rank gathers the group's rows and routes the whole group: its
    recorded choices and its (token, choice) pairs routed and kept are
    the one-rank prefill's of the global batch, at the global group's
    capacity of 20 an expert, where each rank's 32 tokens grouped alone
    would get 10 and keep other pairs. The prefill, decode and train
    outputs are held to GSPMD's by the parametrized tests above."""
    ranks, one, _ = results[(2, 2), "mixtral-span"]
    assert len(ranks) == 4
    want = one["prefill_routes"]
    assert want["routed"] == 4 * 16 * 2 * 4  # 64 tokens, top-2, 4 layers
    for r in ranks:
        got = r["prefill_routes"]
        assert (got["routed"], got["kept"]) == (want["routed"], want["kept"])
        assert len(got["routes"]) == len(want["routes"]) == 4
        for a, b in zip(got["routes"], want["routes"]):
            assert a.shape == (1, 64, 2)
            np.testing.assert_array_equal(a, b)
    cfg = cases.config("mixtral-8x7b", {})
    assert max(int(64 * 2 / 8 * cfg.capacity_factor), 1) == 20
    assert max(int(32 * 2 / 8 * cfg.capacity_factor), 1) == 10


def test_mamba2_and_other_caches_still_raise_naming_a13_tp():
    """Kept under its name from before mamba2's tensor parallelism was
    ported: the step makers now build for mamba2 over a model axis of 2,
    and ``cache_shardings`` cuts the SSM cache as the reference does
    (the conv window by channels, the state by heads, the batch over
    data), as it does the hybrid's and whisper's."""
    from repro_torch.models import ssm

    cfg = reduced_config(get_config("mamba2-780m"))
    sizes = {"data": 2, "model": 2}
    for make in (tsteps.make_prefill_step, tsteps.make_serve_step):
        assert callable(make(cfg, mesh=sizes, device="cpu"))
    c_sh = tsteps.cache_shardings(
        ssm.init_decode_cache(cfg, 4, 8, device="meta"), sizes)
    assert c_sh.conv.spec == (None, "data", None, "model")
    assert c_sh.state.spec == (None, "data", "model")
    assert c_sh.length.spec == ()
    with pytest.raises(TypeError, match="no cache rule"):
        tsteps.cache_shardings((torch.zeros(1),), sizes)


def _logged(stdout: str) -> list[list[str]]:
    return [line.split()[:4] for line in stdout.splitlines()
            if line.startswith("step ")]


def _cli_losses_match(tmp_path, arch: str, extra: list[str]) -> dict:
    """The train CLI with ``--arch arch --reduced`` over ``--mesh 1x2``
    (two gloo CPU ranks, the tp profile's model axis) logs the same
    losses as ``--mesh 1x1``, both with ``extra``."""
    common = ["--arch", arch, "--reduced", "--device", "cpu",
              "--global-batch", "2", "--seq-len", "32", "--log-every", "1",
              *extra]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {
        name: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *common,
             *more, "--ckpt-dir", str(tmp_path / name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for name, more in (("one", []),
                           ("tp", ["--mesh", "1x2", "--backend", "gloo"]))}
    outs = {k: p.communicate(timeout=300) + (p.returncode,)
            for k, p in procs.items()}
    for name, (_, err, rc) in outs.items():
        assert rc == 0, (name, err)
    one, tp = (_logged(outs[k][0]) for k in ("one", "tp"))
    assert one and one == tp
    return outs


def test_train_cli_over_a_model_axis_logs_the_one_process_losses(tmp_path):
    """The train CLI with ``--arch qwen2.5-3b --reduced`` over ``--mesh
    1x2`` (two gloo CPU ranks, the tp profile's model axis), restarting
    once from its checkpoint: the same logged losses as ``--mesh
    1x1``."""
    outs = _cli_losses_match(tmp_path, "qwen2.5-3b", [
        "--steps", "5", "--ckpt-every", "2", "--simulate-failure-at", "3"])
    for out, err, _ in outs.values():
        done = next(x for x in out.splitlines() if x.startswith("done:"))
        assert "restarts=1" in done
        assert re.search("restored at step 2", err)
    one = _logged(outs["one"][0])
    assert [s[1] for s in one] == ["0", "1", "2", "2", "3", "4"]


@pytest.mark.parametrize("arch", ("mamba2-780m", "recurrentgemma-9b"))
def test_train_cli_runs_mamba2_and_the_hybrid_over_a_model_axis(tmp_path,
                                                                arch):
    """``train.py --reduced --device cpu --mesh 1x2 --backend gloo`` for
    mamba2 and the hybrid: its logged losses equal ``--mesh 1x1``'s to
    the printed digits."""
    outs = _cli_losses_match(tmp_path, arch, ["--steps", "3"])
    assert len(_logged(outs["tp"][0])) == 3
    assert f"mesh=1x2  arch={arch}" in outs["tp"][0]
