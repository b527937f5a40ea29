"""The port's data-parallel and ZeRO train step
(``repro_torch.launch.steps.make_train_step(..., mesh=...)``) against its
one-rank step and against the JAX package's ``jit_train_step`` (GSPMD
over a mesh of 8 host devices).

The reduced mamba2 (4 layers, d_model 64, chunk 16, vocab 512) in
float32 from the reference's ``init_params`` (carried across with
``convert``), Markov batches of 4 x 32 tokens, two AdamW steps, on
meshes (2, 1), (4, 1) and (2, 2) of ``("data", "model")`` under the
``dp`` profile and (2, 1) under ``tp``, each with and without ``fsdp``.
The port's ranks are CPU processes over gloo, spawned by
``launch.mesh.run_on_mesh`` once per mesh for the whole module, the
three at once (``tests/_torch_dp_cases.py``); every rank checks its
``BatchIterator`` rows against the global batch cut by ``batch_spec``.

Tolerances (relative L2 per leaf; scalars relative):
* against the port's one-rank step at the same global batch, 1e-5: the
  same float32 function, the token mean summed per rank;
* against the reference, 1e-4, the training tolerance
  (``tests/test_torch_train.py``): the gradient's 1e-4 through Adam;
* ZeRO against plain data parallelism on the same mesh: over two
  ranks the synced gradients and the loss equal bit for bit (every sum
  is a + b), over four within 1e-6; the parameters within 1e-5 (the
  clip's global norm is summed over blocks in another order).

The parameters are held to these tolerances where Adam's update is
fixed by the gradients (:func:`_close_params`). Adam moves an element by
up to ``lr`` whatever the size of its gradient, so an element whose
gradient is a near-cancellation of its terms (a step-0 gradient below
``SMALL_GRAD`` of its leaf's RMS) may move by any amount in
``[-lr, lr]`` on two correct implementations that round its sum
differently: such an element is held to ``|Δ| ≤ 2·Σ lr``. From this
module's ``PRNGKey(7)``, one ``blocks/A_log`` element with a step-0
gradient of 4.7e-7 makes the reference's own (4, 1)-mesh step and its
single-device step differ by 6.2e-4 over the whole leaf. Over seeds 0-8
the rule leaves under 1% of the elements to that bound and the rest
within half of each tolerance.
"""
import dataclasses
import os
import types
from concurrent.futures import ThreadPoolExecutor

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import _torch_dp_cases as cases  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.distrib import sharding as jshlib  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import MarkovLMDataset  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import run_on_mesh  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

AXES = ("data", "model")
DATA = dict(vocab=512, seq=32, batch=4, seed=3, steps=2)
OPT = dict(lr_peak=3e-3, warmup_steps=1, total_steps=2)
# mesh shape -> {case name: (profile, fsdp)}
MESHES = {
    (2, 1): {"dp": ("dp", False), "dp_fsdp": ("dp", True),
             "tp": ("tp", False), "tp_fsdp": ("tp", True)},
    (4, 1): {"dp": ("dp", False), "dp_fsdp": ("dp", True)},
    (2, 2): {"dp": ("dp", False), "dp_fsdp": ("dp", True)},
}
CASES = [(shape, name) for shape, named in MESHES.items() for name in named]
PROFILES = [(shape, profile) for shape, named in MESHES.items()
            for profile in sorted({p for p, _ in named.values()})]
ONE_RANK_TOL = 1e-5
REF_TOL = 1e-4
ZERO_TOL = 1e-6
# A step-0 gradient element below SMALL_GRAD of its leaf's RMS leaves
# its Adam step unfixed (see the module docstring).
SMALL_GRAD = 3e-3


@pytest.fixture(autouse=True)
def _f32_reference():
    """The reference in JAX's default float32, whatever another test file
    set for the process."""
    with jax.enable_x64(False):
        yield


def _jax_params():
    """(the reference's reduced mamba2 in float32, its init_params)."""
    jcfg = dataclasses.replace(
        jreg.reduced_config(jreg.get_config(cases.ARCH)), dtype="float32")
    return jcfg, jssm.init_params(jcfg, jax.random.PRNGKey(7))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _batches():
    ds = MarkovLMDataset(DATA["vocab"], DATA["seq"], seed=DATA["seed"])
    return [ds.batch(i, 0, DATA["batch"]) for i in range(DATA["steps"])]


def _one_rank(params_np):
    """The port's step without a mesh on the global batch: per-step
    metrics, step 0's gradient, the parameters after the last step."""
    cfg = cases.config()
    params = convert.ssm_params_from_numpy(params_np, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in _batches()]
        _, _, grads = tsteps.make_grad_step(cfg, device="cpu")(params,
                                                               batches[0])
        step = tsteps.make_train_step(cfg, AdamWConfig(**OPT), device="cpu")
        opt = adamw_init(params)
        rec = {"loss": [], "grad_norm": [], "lr": []}
        for b in batches:
            params, opt, m = step(params, opt, b)
            for k in rec:
                rec[k].append(float(m[k]))
    finally:
        torch.set_num_threads(threads)
    rec["grads0"] = cases.flat(grads)
    rec["params"] = cases.flat(params)
    rec["mu"] = cases.flat(opt.mu)
    return rec


def _reference(jcfg, jparams):
    """The reference's ``jit_train_step`` on each mesh under each profile
    (``fsdp=False``: the port's ZeRO layout is held to the same GSPMD
    step, its parameters laid out otherwise): per-step metrics and the
    parameters after the last step; and ``jax.value_and_grad`` of the
    global batch."""
    out = {}
    opt_cfg = jadamw.AdamWConfig(**OPT)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in _batches()]
    batch_abs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in batches[0].items()}
    for shape, named in MESHES.items():
        devices = np.array(jax.devices()[:int(np.prod(shape))])
        mesh = Mesh(devices.reshape(shape), AXES)
        for profile in sorted({p for p, _ in named.values()}):
            with jshlib.rules_context(mesh, jshlib.profile_act_rules(profile)):
                fn, (p_sh, o_sh, b_sh) = jsteps.jit_train_step(
                    jcfg, mesh, batch_abs, opt_cfg=opt_cfg, donate=False,
                    profile=profile)
                params = jax.device_put(jparams, p_sh)
                opt = jax.device_put(jadamw.adamw_init(params), o_sh)
                rec = {"loss": [], "grad_norm": [], "lr": []}
                for b in batches:
                    b = {k: jax.device_put(v, b_sh[k]) for k, v in b.items()}
                    params, opt, m = fn(params, opt, b)
                    for k in rec:
                        rec[k].append(float(m[k]))
            rec["params"] = _flat_jax(params)
            out[shape, profile] = rec
    (_, _), grads = jax.value_and_grad(jssm.lm_loss, has_aux=True)(
        jparams, jcfg, batches[0])
    out["grads0"] = _flat_jax(grads)
    return out


@pytest.fixture(scope="module")
def results():
    """(ranks, one_rank, reference): the three meshes' ranks spawned at
    once in the background ({shape: every rank's results}) while this
    process runs the port's one-rank step and the reference."""
    with jax.enable_x64(False):
        jcfg, jparams = _jax_params()
        params_np = _numpy(jparams)
        with ThreadPoolExecutor(len(MESHES)) as pool:
            jobs = {shape: pool.submit(
                run_on_mesh, cases.train_rank, shape, AXES, backend="gloo",
                device="cpu", args=(named, params_np, DATA, OPT),
                timeout=300) for shape, named in MESHES.items()}
            one_rank = _one_rank(params_np)
            reference = _reference(jcfg, jparams)
            ranks = {shape: job.result() for shape, job in jobs.items()}
    return ranks, one_rank, reference


@pytest.fixture(scope="module")
def ranks(results):
    return results[0]


@pytest.fixture(scope="module")
def one_rank(results):
    return results[1]


@pytest.fixture(scope="module")
def reference(results):
    return results[2]


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _close_trees(got, want, tol, what):
    assert set(got) == set(want), (sorted(got), sorted(want))
    worst = {k: _rel(got[k], want[k]) for k in want}
    assert max(worst.values()) <= tol, (what, worst)


def _close_series(got, want, tol, what):
    for g, w in zip(got, want, strict=True):
        assert abs(g - w) <= tol * abs(w), (what, got, want)


def _close_params(got, want, grads0, lr, tol, what):
    """Parameters after the steps within ``tol`` relative L2 per leaf
    over the elements whose step-0 gradient ``grads0`` is zero or above
    ``SMALL_GRAD`` of its leaf's RMS; every other element within
    ``2 · sum(lr)`` absolute, the most Adam steps of opposite sign can
    part it."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    worst, loose = {}, {}
    for k in want:
        g = grads0[k]
        fixed = ((np.abs(g) > SMALL_GRAD * np.sqrt(np.mean(np.square(g))))
                 | (g == 0))
        if fixed.any():
            worst[k] = _rel(got[k][fixed], want[k][fixed])
        if not fixed.all():
            loose[k] = float(np.abs(got[k] - want[k])[~fixed].max())
    assert worst and max(worst.values()) <= tol, (what, worst)
    assert max(loose.values(), default=0.0) <= 2 * sum(lr), (what, loose)


@pytest.mark.parametrize("shape,name", CASES)
def test_dp_step_matches_one_rank_step(ranks, one_rank, shape, name):
    got = ranks[shape][0][name]
    for k in ("loss", "grad_norm", "lr"):
        _close_series(got[k], one_rank[k], ONE_RANK_TOL, k)
    _close_trees(got["grads0"], one_rank["grads0"], ONE_RANK_TOL,
                 "synced gradient of step 0")
    _close_params(got["params"], one_rank["params"], one_rank["grads0"],
                  one_rank["lr"], ONE_RANK_TOL, "parameters after 2 steps")
    _close_trees(got["mu"], one_rank["mu"], ONE_RANK_TOL,
                 "first moments after 2 steps")


@pytest.mark.parametrize("shape,name", CASES)
def test_dp_step_matches_reference_jit_train_step(ranks, reference, shape,
                                                  name):
    got = ranks[shape][0][name]
    want = reference[shape, MESHES[shape][name][0]]
    for k in ("loss", "grad_norm", "lr"):
        _close_series(got[k], want[k], REF_TOL, k)
    _close_trees(got["grads0"], reference["grads0"], REF_TOL,
                 "synced gradient of step 0 vs jax.value_and_grad")
    _close_params(got["params"], want["params"], reference["grads0"],
                  want["lr"], REF_TOL, "parameters after 2 steps")


@pytest.mark.parametrize("shape,profile", PROFILES)
def test_zero_equals_plain_data_parallel(ranks, shape, profile):
    """Over two data-parallel ranks every sum is a + b in both
    (all-reduce, reduce-scatter), so the synced gradients and the loss
    are equal bit for bit; over four, gloo's all-reduce and
    reduce-scatter add the four terms in other orders (1e-6)."""
    dp, zero = (ranks[shape][0][profile + s] for s in ("", "_fsdp"))
    n_dp = int(np.prod(shape)) if profile == "dp" else shape[0]
    if n_dp == 2:
        for k in dp["grads0"]:
            assert np.array_equal(zero["grads0"][k], dp["grads0"][k]), k
        assert zero["loss"] == dp["loss"]
    else:
        _close_trees(zero["grads0"], dp["grads0"], ZERO_TOL, "grads0")
        _close_series(zero["loss"], dp["loss"], ZERO_TOL, "loss")
    _close_params(zero["params"], dp["params"], dp["grads0"], dp["lr"],
                  ONE_RANK_TOL, "params")


@pytest.mark.parametrize("shape,name", CASES)
def test_every_rank_agrees_and_holds_its_shards(ranks, shape, name):
    """Every rank reports the same global metrics and parameters; under
    fsdp the leaves are held as blocks of 1/n of the cut dim, without it
    whole; the bytes sent per step match the ring count."""
    results = [r[name] for r in ranks[shape]]
    for r in results[1:]:
        assert r["loss"] == results[0]["loss"]
        assert r["grad_norm"] == results[0]["grad_norm"]
        for k, v in results[0]["params"].items():
            assert np.array_equal(r["params"][k], v), k
    n_ranks = int(np.prod(shape))
    profile, fsdp = MESHES[shape][name]
    n_dp = n_ranks if profile == "dp" else shape[0]
    full = {k: v.shape for k, v in results[0]["params"].items()}
    shards = results[0]["shard_shapes"]
    n_values = sum(int(np.prod(s)) for s in full.values())
    cut = [k for k in full if shards[k] != full[k]]
    if not fsdp:
        assert not cut
        want = 2 * (n_dp - 1) / n_dp * 4 * n_values
    else:
        assert "blocks/in_proj" in cut and "embed" in cut
        for k in cut:
            assert int(np.prod(full[k])) == n_dp * int(np.prod(shards[k])), k
        held = sum(int(np.prod(shards[k])) for k in full)
        assert held < n_values
        want = 2 * (n_dp - 1) / n_dp * 4 * n_values
    # plus the token counts, the loss and (fsdp) the norm's scalars
    assert want <= results[0]["bytes"] <= want + 64 * n_dp, (
        results[0]["bytes"], want)


def test_tp_profile_with_a_model_axis_raises_naming_the_roadmap_item():
    """Kept under its name from before mamba2's tensor parallelism was
    ported: the tp profile cuts mamba2's leaves over ``model`` as the
    reference's ``param_spec`` does (``in_proj``'s columns, the conv
    taps and bias, the heads, ``out_proj``'s rows; under fsdp the
    largest whole dim of the eligible leaves over ``data``), where it
    raised before; the dp profile and a model axis of 1 cut nothing
    over ``model``; fsdp without a mesh still raises."""
    cfg = cases.config()
    abstract = tsteps.get_model(cfg).abstract_params(cfg)
    for sizes in ({"data": 2, "model": 2}, {"data": 1, "model": 4},
                  {"pod": 2, "data": 2, "model": 2}):
        fake = types.SimpleNamespace(axis_names=tuple(sizes),
                                     devices=np.empty(tuple(sizes.values())))
        for fsdp in (False, True):
            p_sh, o_sh = tsteps.train_shardings(cfg, sizes, profile="tp",
                                                fsdp=fsdp)
            assert o_sh.mu is p_sh
            for path, sh in tree_leaves_with_path(p_sh):
                name = "/".join(path)
                want = jshlib.param_spec(name, tuple(
                    _leaf(abstract, path).shape), fake, fsdp=fsdp)
                assert sh.spec == tuple(want), name
            specs = {"/".join(p): sh.spec
                     for p, sh in tree_leaves_with_path(p_sh)}
            assert "model" in specs["blocks/in_proj"]
            assert specs["blocks/conv_w"][1] == "model"
    for sizes, profile in (({"data": 4, "model": 1}, "tp"),
                           ({"data": 2, "model": 2}, "dp")):
        p_sh, _ = tsteps.train_shardings(cfg, sizes, profile=profile)
        assert all(sh.spec == () for sh in tree_leaves(p_sh))
    with pytest.raises(ValueError, match="fsdp=True needs a mesh"):
        tsteps.make_train_step(cfg, AdamWConfig(), device="cpu", fsdp=True)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree
