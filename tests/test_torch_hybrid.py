"""The hybrid family in the port (``repro_torch.models.hybrid``:
recurrentgemma-9b's RG-LRU scan, recurrent and local-attention blocks,
forward, loss, gradients, the ring decode and training) against the JAX
package, at the reference's reduced size (``reduced_config``: 5 layers
= one (rec, rec, att) super-block and two tail recurrent blocks,
d_model 64, 4 heads of 16 over one KV head, LRU width 64, d_ff 128,
vocab 512, local window 16).

Both packages compute on the same weights: the JAX ``init_params`` tree
crosses through ``convert.model_params_from_numpy``; other inputs are
numpy draws from a seed. The reference computes this family in plain
``jnp`` (its conv is the plain ``kref`` conv, its scan
``lax.associative_scan``), so nothing here runs in interpret mode.

Tolerances:
* forward values (the scan, the blocks, the logits, the decode steps
  and caches) within 1e-5 of max |ref| in float32: the same sums in
  another order (the scan's doubling rounds against the reference's
  odd-even tree);
* the loss within 1e-5 relative, each gradient leaf (and the scan's
  input gradients) within 1e-4 relative L2 of ``jax.grad``'s;
* bfloat16 logits no further from the reference's float32 than 1.5x
  the reference's own bfloat16 logits are (``tests/test_torch_dense_
  train.py``'s rule for bf16);
* decode against the teacher-forced forward within 5e-4 absolute
  (``tests/test_system.py:67-85``);
* the data-parallel step on a (2, 1) gloo mesh within 1e-5 of the
  one-rank step (``tests/test_torch_dp_train.py``), its parameters by
  that file's rule for near-cancelled gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_dp_cases as cases
from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import hybrid as jh
from repro.models import layers as jl
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.data import MarkovLMDataset
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import hybrid as th
from repro_torch.models import layers as tl
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_leaves_with_path, tree_map

ARCH = "recurrentgemma-9b"
TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_MULTIPLE = 1.5
DECODE_VS_FORWARD = 5e-4
DP_TOL = 1e-5
# A step-0 gradient element below SMALL_GRAD of its leaf's RMS leaves
# its Adam step unfixed (``tests/test_torch_dp_train.py``).
SMALL_GRAD = 3e-3


@pytest.fixture(autouse=True)
def _f32_reference_and_two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with jax.enable_x64(False):
            yield
    finally:
        torch.set_num_threads(threads)


def _cfgs(**kw):
    j = dataclasses.replace(jreg.reduced_config(jreg.get_config(ARCH)), **kw)
    t = dataclasses.replace(treg.reduced_config(treg.get_config(ARCH)), **kw)
    return j, t


def _params(jcfg, seed=0):
    params = jh.init_params(jcfg, jax.random.PRNGKey(seed))
    return params, convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, np.float64)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
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


def _shapes(tree) -> dict[str, tuple]:
    """Each leaf's shape by path, of a JAX tree (arrays or abstract) or
    a port tree (tensors, meta tensors too)."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return {"/".join(path): tuple(v.shape)
                for path, v in tree_leaves_with_path(tree)}
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)


def _batch(cfg, b, s, step=0, seed=0):
    nb = MarkovLMDataset(cfg.vocab, s, seed=seed).batch(step, 0, b)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _close_params(got, want, grads0, tol, lr, what):
    """Per leaf within ``tol`` relative L2 over the elements whose
    step-0 gradient is zero or above ``SMALL_GRAD`` of its leaf's RMS;
    the others within ``2 · lr`` (Adam moves them by up to ``lr``
    whatever the gradient's size)."""
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
    assert max(loose.values(), default=0.0) <= 2 * lr, (what, loose)


# --- the tree ----------------------------------------------------------------


def test_params_have_the_reference_tree_shapes_and_values():
    """``init_params`` and ``abstract_params`` give the reference's tree
    and shapes (the full config's on meta tensors too); the constants
    (norms, biases, Λ = 2) equal the reference's."""
    for jcfg, tcfg in (_cfgs(), (jreg.get_config(ARCH),
                                 treg.get_config(ARCH))):
        assert _shapes(th.abstract_params(tcfg)) == _shapes(jax.eval_shape(
            lambda k: jh.init_params(jcfg, k), jax.random.PRNGKey(0)))
    jcfg, tcfg = _cfgs()
    want = _flat(_params(jcfg)[0])
    got = _flat(th.init_params(tcfg, seed=0, device="cpu"))
    assert _shapes(got) == _shapes(want)
    for k in ("super/rec1/a_param", "tail_rec/ln", "super/att/ln1",
              "final_norm", "super/rec2/b_i_gate"):
        assert np.array_equal(got[k], want[k]), k
    assert th.split_layers(38, 3) == jh.split_layers(38, 3) == (12, 2, 12)


# --- RG-LRU --------------------------------------------------------------------


def _scan_inputs(near_zero: bool, seed=0, b=2, l=64, w=16):
    """(x, r, i, lam, h0) float32 numpy; ``near_zero``: recurrence gates
    from 0 up to 1e-4 (a → 1, where 1 − a² cancels), some exactly 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, w)).astype(np.float32)
    if near_zero:
        r = (10.0 ** rng.uniform(-12, -4, (b, l, w))).astype(np.float32)
        r[:, ::7] = 0.0
    else:
        r = rng.uniform(0.01, 0.99, (b, l, w)).astype(np.float32)
    i = rng.uniform(0.01, 0.99, (b, l, w)).astype(np.float32)
    lam = rng.uniform(-1.0, 3.0, (w,)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return x, r, i, lam, h0


@pytest.mark.parametrize("near_zero", (False, True))
@pytest.mark.parametrize("with_h0", (False, True))
def test_rg_lru_scan_matches_reference(with_h0, near_zero):
    x, r, i, lam, h0 = _scan_inputs(near_zero)
    args = (x, r, i, lam) + ((h0,) if with_h0 else ())
    jy, jlast = jax.jit(jh.rg_lru_scan)(*map(jnp.asarray, args))
    ty, tlast = th.rg_lru_scan(*map(torch.from_numpy, args))
    assert _rel(ty, jy) <= TOL and _rel(tlast, jlast) <= TOL
    assert np.isfinite(_np(ty)).all()


@pytest.mark.parametrize("near_zero", (False, True))
@pytest.mark.parametrize("with_h0", (False, True))
def test_rg_lru_scan_gradient_matches_jax_grad(with_h0, near_zero):
    """The gradients of every input (the custom backward: the same
    doubling scan from the end) against ``jax.grad`` of the reference,
    through both outputs with random cotangents."""
    x, r, i, lam, h0 = _scan_inputs(near_zero, seed=1)
    rng = np.random.default_rng(2)
    cy = rng.standard_normal(x.shape).astype(np.float32)
    clast = rng.standard_normal(h0.shape).astype(np.float32)
    args = (x, r, i, lam) + ((h0,) if with_h0 else ())

    def jloss(*a):
        y, last = jh.rg_lru_scan(*a)
        return (y * cy).sum() + (last * clast).sum()

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(args)))))(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, last = th.rg_lru_scan(*leaves)
    ((y * torch.from_numpy(cy)).sum()
     + (last * torch.from_numpy(clast)).sum()).backward()
    for name, t, w in zip("x r i lam h0".split(), leaves, want):
        assert np.isfinite(_np(t.grad)).all(), name
        assert _rel_l2(t.grad, w) <= GRAD_TOL, name


def test_linear_scan_is_log_depth_and_matches_the_sequential_recurrence():
    """``linear_scan`` equals ``h_t = a_t h_{t−1} + b_t`` step by step
    (float64), and its forward and backward dispatch a number of ops
    that grows by a constant per doubling of the length: a loop over
    rounds, none over time."""
    rng = np.random.default_rng(3)

    def ops(n):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (1, n, 4))).requires_grad_()
        b = torch.from_numpy(rng.standard_normal((1, n, 4))).requires_grad_()
        count = [0]

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                count[0] += 1
                return func(*args, **(kwargs or {}))

        with Count():
            h = th.linear_scan(a, b)
            h.sum().backward()
        want = np.zeros((1, 4))
        seq = []
        for t in range(n):
            want = a[:, t].detach().numpy() * want + b[:, t].detach().numpy()
            seq.append(want)
        assert np.allclose(h.detach().numpy(), np.stack(seq, 1), rtol=1e-12,
                           atol=1e-12)
        return count[0]

    counts = [ops(n) for n in (256, 512, 1024, 2048)]
    steps = np.diff(counts)
    assert (steps == steps[0]).all() and 0 < steps[0] < 40, counts


# --- the blocks ------------------------------------------------------------------


def _layer(tree, i=0):
    return jax.tree.map(lambda p: p[i], tree)


def test_rec_block_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    x = np.random.default_rng(4).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    want = jax.jit(jh.rec_block, static_argnums=2)(
        jnp.asarray(x), _layer(jp["super"]["rec1"]), jcfg)
    got = th.rec_block(torch.from_numpy(x),
                       tree_map(lambda p: p[0], tp["super"]["rec1"]), tcfg)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("s", (12, 40))
def test_att_block_matches_reference(s):
    """The local attention block inside (12) and past (40) its window of
    16."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=2)
    x = np.random.default_rng(5).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s))
    jcos, jsin = jl.rope_cos_sin(jnp.asarray(pos), jcfg.hd, jcfg.rope_theta)
    tcos, tsin = tl.rope_cos_sin(torch.from_numpy(pos.copy()), tcfg.hd,
                                 tcfg.rope_theta)
    want = jax.jit(jh.att_block, static_argnums=2)(
        jnp.asarray(x), _layer(jp["super"]["att"]), jcfg, jcos, jsin)
    got = th.att_block(torch.from_numpy(x),
                       tree_map(lambda p: p[0], tp["super"]["att"]), tcfg,
                       tcos, tsin)
    assert _rel(got, want) <= TOL


# --- forward, loss, gradients -------------------------------------------------


@pytest.mark.parametrize("b,s,window", ((2, 32, None), (1, 4096, 1024)))
def test_forward_and_loss_match_reference(b, s, window, monkeypatch):
    """f32 logits and loss; at s = 4096 with a window of 1024 the
    attention takes the banded chunked path (KV chunks of the window)."""
    kw = {} if window is None else {"local_window": window}
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, seed=3)
    jb, tb = _batch(jcfg, b, s, seed=3)
    calls = []
    plain = tl.chunked_attention

    def counting(*a, **k):
        calls.append((k["q_chunk"], k["kv_chunk"]))
        return plain(*a, **k)

    monkeypatch.setattr(tl, "chunked_attention", counting)
    want, jloss = jax.jit(lambda p, b: (jh.forward(p, jcfg, b["tokens"])[0],
                                        jh.lm_loss(p, jcfg, b)[0]))(jp, jb)
    with torch.no_grad():
        got, aux = th.forward(tp, tcfg, tb["tokens"])
        tloss, metrics = th.lm_loss(tp, tcfg, tb)
    assert _rel(got, want) <= TOL
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL * float(jloss)
    assert float(aux) == 0.0 and set(metrics) == {"xent"}
    assert calls == ([] if window is None else [(1024, 1024)] * 2)


@pytest.fixture(scope="module")
def reference_grads():
    """(JAX params, port params, port batch, the reference's loss and
    gradient leaves) at remat ``none``: the reference's remat changes
    what its backward recomputes, not the values."""
    with jax.enable_x64(False):
        jcfg, _ = _cfgs()
        jp, tp = _params(jcfg, seed=4)
        jb, tb = _batch(jcfg, 2, 32, seed=4)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            jh.lm_loss, has_aux=True), static_argnums=1)(jp, jcfg, jb)
        return tp, tb, float(loss), _flat(grads)


@pytest.mark.parametrize("remat", ("none", "selective"))
def test_lm_loss_and_every_gradient_leaf_match_reference(remat,
                                                         reference_grads):
    _, tcfg = _cfgs(remat=remat)
    tp, tb, want, want_g = reference_grads
    loss, _, grads = tsteps.make_grad_step(tcfg, device="cpu")(tp, tb)
    assert abs(float(loss) - want) <= LOSS_TOL * want
    got = _flat(grads)
    assert set(got) == set(want_g)
    worst = {k: _rel_l2(got[k], want_g[k]) for k in want_g}
    assert max(worst.values()) <= GRAD_TOL, worst


def test_bf16_forward_lies_as_near_the_f32_reference_as_its_own_bf16():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=5)
    jt, tt = _tokens(jcfg, 2, 48, seed=5)
    fwd = jax.jit(jh.forward, static_argnums=1)
    want, _ = fwd(jp, jcfg, jt)
    own, _ = fwd(jp, dataclasses.replace(jcfg, dtype="bfloat16"), jt)
    with torch.no_grad():
        got, _ = th.forward(tp, dataclasses.replace(tcfg, dtype="bfloat16"),
                            tt)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= BF16_MULTIPLE * _rel(own, want), (
        _rel(got, want), _rel(own, want))


# --- decode ----------------------------------------------------------------------


def test_decode_step_matches_reference_and_forward_through_a_wrapping_ring():
    """40 steps from an empty cache of max_len 64: the ring of 16 slots
    is overwritten twice over. Each step's logits and the final caches
    against the reference's ``decode_step``; the logits against the
    teacher-forced forward."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=6)
    steps = 40
    jt, tt = _tokens(jcfg, 2, steps, seed=6)
    jstep = jax.jit(jh.decode_step, static_argnums=1)
    jcache = jh.init_decode_cache(jcfg, 2, 64)
    tcache = th.init_decode_cache(tcfg, 2, 64, device="cpu")
    assert tcache.k.shape == jcache.k.shape and tcache.k.shape[2] == 16
    for name in tcache._fields:
        assert getattr(tcache, name).dtype == getattr(
            torch, str(getattr(jcache, name).dtype)), name
    with torch.no_grad():
        full, _ = th.forward(tp, tcfg, tt)
        worst = 0.0
        for t in range(steps):
            jlg, jcache = jstep(jp, jcfg, jt[:, t:t + 1], jcache)
            tlg, tcache = th.decode_step(tp, tcfg, tt[:, t:t + 1], tcache)
            assert _rel(tlg, jlg) <= TOL, t
            worst = max(worst, float((tlg - full[:, t]).abs().max()))
    for name in ("lru_h", "conv", "k", "v"):
        assert _rel(getattr(tcache, name), getattr(jcache, name)) <= TOL, name
    assert int(tcache.length) == steps
    assert worst < DECODE_VS_FORWARD, worst


def test_decode_cache_does_not_grow_with_max_len():
    """The reference's ``test_long_context_decode_is_bounded`` (reduced:
    max_len 64 and 524288 alike); at full width the ring stops growing
    at the window of 2048 (meta tensors, no storage)."""
    def size(cache):
        return sum(v.numel() for v in cache)

    _, tcfg = _cfgs()
    small = th.init_decode_cache(tcfg, 1, 64, device="cpu")
    huge = th.init_decode_cache(tcfg, 1, 524288, device="cpu")
    assert size(small) == size(huge)
    full = treg.get_config(ARCH)
    at = {n: size(th.init_decode_cache(full, 1, n, device="meta"))
          for n in (64, 2048, 524288)}
    assert at[64] < at[2048] == at[524288], at
    jfull = jreg.get_config(ARCH)
    assert at[524288] == sum(np.prod(v.shape) for v in jax.eval_shape(
        lambda: jh.init_decode_cache(jfull, 1, 524288)))


# --- training ---------------------------------------------------------------------


def test_make_train_step_matches_reference():
    """One AdamW step of ``make_train_step`` against the reference's,
    both from the same parameters and batch."""
    jcfg, tcfg = _cfgs()
    opt_kw = dict(lr_peak=3e-3, warmup_steps=1, total_steps=2)
    jp, tp = _params(jcfg, seed=7)
    jb, tb = _batch(jcfg, 2, 32, seed=7)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jadamw.AdamWConfig(**opt_kw)))
    jp1, jo1, jm = jstep(jp, jadamw.adamw_init(jp), jb)
    step = tsteps.make_train_step(tcfg, tadamw.AdamWConfig(**opt_kw),
                                  device="cpu")
    _, _, grads0 = tsteps.make_grad_step(tcfg, device="cpu")(tp, tb)
    tp1, to1, tm = step(tp, tadamw.adamw_init(tp), tb)
    assert set(tm) == set(jm) == {"xent", "loss", "grad_norm", "lr"}
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= GRAD_TOL * abs(
            float(jm[k])), k
    _close_params(_flat(tp1), _flat(jp1), _flat(grads0), GRAD_TOL,
                  float(jm["lr"]), "parameters after a step")
    got, want = _flat(to1.mu), _flat(jo1.mu)
    assert max(_rel_l2(got[k], want[k]) for k in want) <= GRAD_TOL


def test_data_parallel_step_on_two_gloo_ranks_equals_one_rank():
    """The generic data-parallel step (``make_train_step(mesh=)``, the
    tp profile with a model axis of one) of the reduced hybrid over a
    (2, 1) mesh of CPU ranks against the one-rank step on the global
    batch."""
    _, tcfg = _cfgs()
    params = th.init_params(tcfg, seed=8, device="cpu")
    params_np = tree_map(lambda v: v.numpy(), params)
    data = dict(vocab=tcfg.vocab, seq=32, batch=4, seed=8)
    opt_kw = dict(lr_peak=3e-3, warmup_steps=1, total_steps=2)
    ranks = run_on_mesh(cases.hybrid_rank, (2, 1), ("data", "model"),
                        backend="gloo", device="cpu",
                        args=(params_np, data, opt_kw), timeout=300)
    batch = {k: torch.from_numpy(v) for k, v in MarkovLMDataset(
        data["vocab"], data["seq"], seed=data["seed"]).batch(
            0, 0, data["batch"]).items()}
    _, _, grads0 = tsteps.make_grad_step(tcfg, device="cpu")(params, batch)
    step = tsteps.make_train_step(tcfg, tadamw.AdamWConfig(**opt_kw),
                                  device="cpu")
    one, _, m = step(params, tadamw.adamw_init(params), batch)
    grads0, one = _flat(grads0), _flat(one)
    for r in ranks:
        for k in ("loss", "grad_norm"):
            assert abs(r[k] - float(m[k])) <= DP_TOL * float(m[k]), k
        assert max(_rel_l2(r["grads0"][k], grads0[k]) for k in grads0) \
            <= DP_TOL
        _close_params(r["params"], one, grads0, DP_TOL, float(m["lr"]),
                      "parameters after a data-parallel step")


def test_train_and_serve_clis_run_the_hybrid(tmp_path, capsys):
    ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                 "3", "--global-batch", "2", "--seq-len", "32",
                 "--ckpt-every", "2", "--log-every", "1", "--ckpt-dir",
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and f"arch={ARCH}" in out
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                 "2", "--steps", "20", "--max-len", "16"])
    assert "generated (2, 21) tokens" in capsys.readouterr().out
    # over a model axis of 2 (gloo CPU ranks), which raised before the
    # hybrid's tensor parallelism was ported
    assert ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--mesh", "1x2", "--backend", "gloo", "--steps", "2",
                        "--global-batch", "2", "--seq-len", "16",
                        "--ckpt-dir", str(tmp_path / "tp")]) is None
