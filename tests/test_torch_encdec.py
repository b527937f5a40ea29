"""The encoder-decoder family in the port (``repro_torch.models.encdec``:
whisper-small's encoder, teacher-forced decoder, loss, gradients,
short-form decode and training) against the JAX package, at the
reference's reduced size (``reduced_config``: 2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, d_ff 128, vocab 512, 32 encoder
frames, 24 target tokens). Also the tensor-parallel layouts of the
hybrid and encoder-decoder families: their parameter and cache specs
(``tests/test_torch_tp.py`` runs them against GSPMD).

Both packages compute on the same weights: the JAX ``init_params`` tree
crosses through ``convert.model_params_from_numpy``; the frames (the
stubbed frontend's output) are numpy draws from a seed. The reference
computes this family in plain ``jnp``, outside any Pallas kernel.

Tolerances: values within 1e-5 of max |ref| in float32 (the same sums
in another order); the loss within 1e-5 relative and each gradient leaf
within 1e-4 relative L2 of ``jax.grad``'s; bfloat16 logits no further
from the reference's float32 than 1.5x the reference's own bfloat16
logits are; decode against the teacher-forced forward within 5e-4
absolute (``tests/test_system.py:67-85``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import encdec as je
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as te
from repro_torch.models import hybrid as th
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_leaves_with_path

ARCH = "whisper-small"
TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_MULTIPLE = 1.5
DECODE_VS_FORWARD = 5e-4
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
    params = je.init_params(jcfg, jax.random.PRNGKey(seed))
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
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return {"/".join(path): v.detach().double().numpy()
                for path, v in tree_leaves_with_path(tree)}
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(tree) -> dict[str, tuple]:
    """Each leaf's shape by path, of a JAX tree (arrays or abstract) or
    a port tree (tensors, meta tensors too)."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return {"/".join(path): tuple(v.shape)
                for path, v in tree_leaves_with_path(tree)}
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, b=2, seed=0):
    """(JAX batch, port batch): tokens and labels (b, max_target_len),
    frames (b, encoder_seq, d_model)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, cfg.max_target_len)).astype(
        np.int32)
    nb = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
          "frames": rng.standard_normal(
              (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def test_params_have_the_reference_tree_shapes_and_values():
    """``init_params`` and ``abstract_params`` give the reference's tree
    and shapes (the full config's too); the LayerNorm gains and the
    biases equal the reference's (ones, zeros)."""
    for jcfg, tcfg in (_cfgs(), (jreg.get_config(ARCH),
                                 treg.get_config(ARCH))):
        assert _shapes(te.abstract_params(tcfg)) == _shapes(jax.eval_shape(
            lambda k: je.init_params(jcfg, k), jax.random.PRNGKey(0)))
    jcfg, tcfg = _cfgs()
    want = _flat(_params(jcfg)[0])
    got = _flat(te.init_params(tcfg, seed=0, device="cpu"))
    assert _shapes(got) == _shapes(want)
    for k in ("enc_ln_w", "dec_ln_b", "blocks/lnx_w", "enc_blocks/ln1_w",
              "blocks/xattn/bv", "enc_blocks/b_in"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("embed", "enc_pos", "dec_pos"):  # scale 0.02
        assert 0.015 < got[k].std() < 0.025, k


def test_encode_forward_and_loss_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    jb, tb = _batch(jcfg, seed=1)
    enc, logits, (loss, _) = jax.jit(lambda p, b: (
        je.encode(p, jcfg, b["frames"]),
        je.forward(p, jcfg, b["tokens"], frames=b["frames"])[0],
        je.lm_loss(p, jcfg, b)))(jp, jb)
    with torch.no_grad():
        got_enc = te.encode(tp, tcfg, tb["frames"])
        got, aux = te.forward(tp, tcfg, tb["tokens"], frames=tb["frames"])
        got_loss, metrics = te.lm_loss(tp, tcfg, tb)
    assert _rel(got_enc, enc) <= TOL
    assert _rel(got, logits) <= TOL
    assert abs(float(got_loss) - float(loss)) <= LOSS_TOL * float(loss)
    assert float(aux) == 0.0 and set(metrics) == {"xent"}


def test_bf16_forward_lies_as_near_the_f32_reference_as_its_own_bf16():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=2)
    jb, tb = _batch(jcfg, seed=2)

    def fwd(cfg):
        return jax.jit(lambda p, b: je.forward(
            p, cfg, b["tokens"], frames=b["frames"])[0])(jp, jb)

    want = fwd(jcfg)
    own = fwd(dataclasses.replace(jcfg, dtype="bfloat16"))
    with torch.no_grad():
        got, _ = te.forward(tp, dataclasses.replace(tcfg, dtype="bfloat16"),
                            tb["tokens"], frames=tb["frames"])
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= BF16_MULTIPLE * _rel(own, want), (
        _rel(got, want), _rel(own, want))


def test_lm_loss_and_every_gradient_leaf_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=3)
    jb, tb = _batch(jcfg, seed=3)
    (want, _), want_g = jax.jit(jax.value_and_grad(je.lm_loss, has_aux=True),
                                static_argnums=1)(jp, jcfg, jb)
    loss, _, grads = tsteps.make_grad_step(tcfg, device="cpu")(tp, tb)
    assert abs(float(loss) - float(want)) <= LOSS_TOL * float(want)
    got, want_g = _flat(grads), _flat(want_g)
    assert set(got) == set(want_g)
    worst = {k: _rel_l2(got[k], want_g[k]) for k in want_g}
    assert max(worst.values()) <= GRAD_TOL, worst


def test_decode_over_max_target_len_matches_reference_and_forward():
    """``init_decode_cache`` from the encoder's output (the cross K/V of
    every decoder layer, computed once), then every one of the
    ``max_target_len`` steps: logits and the self-attention caches
    against the reference's ``decode_step``, the logits against the
    teacher-forced forward."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    jb, tb = _batch(jcfg, seed=4)
    jenc = jax.jit(je.encode, static_argnums=1)(jp, jcfg, jb["frames"])
    jcache = je.init_decode_cache(jp, jcfg, jenc)
    with torch.no_grad():
        tcache = te.init_decode_cache(tp, tcfg,
                                      te.encode(tp, tcfg, tb["frames"]))
        full, _ = te.forward(tp, tcfg, tb["tokens"], frames=tb["frames"])
    for name in ("xk", "xv"):
        assert _rel(getattr(tcache, name), getattr(jcache, name)) <= TOL
    assert tcache.k.shape == jcache.k.shape
    jstep = jax.jit(je.decode_step, static_argnums=1)
    worst = 0.0
    with torch.no_grad():
        for t in range(jcfg.max_target_len):
            jlg, jcache = jstep(jp, jcfg, jb["tokens"][:, t:t + 1], jcache)
            tlg, tcache = te.decode_step(tp, tcfg, tb["tokens"][:, t:t + 1],
                                         tcache)
            assert _rel(tlg, jlg) <= TOL, t
            worst = max(worst, float((tlg - full[:, t]).abs().max()))
    for name in ("k", "v"):
        assert _rel(getattr(tcache, name), getattr(jcache, name)) <= TOL
    assert int(tcache.length) == jcfg.max_target_len
    assert worst < DECODE_VS_FORWARD, worst


def test_make_prefill_step_passes_frames_and_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=5)
    jb, tb = _batch(jcfg, seed=5)
    batch = {k: jb[k] for k in ("tokens", "frames")}
    want = jax.jit(jsteps.make_prefill_step(jcfg))(jp, batch)
    with torch.no_grad():
        got = tsteps.make_prefill_step(tcfg, device="cpu")(
            tp, {k: tb[k] for k in ("tokens", "frames")})
    assert got.dtype == torch.float32 and got.shape == (2, jcfg.vocab)
    assert _rel(got, want) <= TOL


def test_make_train_step_matches_reference():
    """One AdamW step of ``make_train_step`` on a batch with frames
    against the reference's."""
    jcfg, tcfg = _cfgs()
    opt_kw = dict(lr_peak=3e-3, warmup_steps=1, total_steps=2)
    jp, tp = _params(jcfg, seed=6)
    jb, tb = _batch(jcfg, seed=6)
    jp1, jo1, jm = jax.jit(jsteps.make_train_step(
        jcfg, jadamw.AdamWConfig(**opt_kw)))(jp, jadamw.adamw_init(jp), jb)
    _, _, grads0 = tsteps.make_grad_step(tcfg, device="cpu")(tp, tb)
    tp1, to1, tm = tsteps.make_train_step(
        tcfg, tadamw.AdamWConfig(**opt_kw), device="cpu")(
            tp, tadamw.adamw_init(tp), tb)
    assert set(tm) == set(jm) == {"xent", "loss", "grad_norm", "lr"}
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= GRAD_TOL * abs(
            float(jm[k])), k
    got, want, g0 = _flat(tp1), _flat(jp1), _flat(grads0)
    lr = float(jm["lr"])
    for k in want:  # near-cancelled gradients: Adam moves them up to lr
        fixed = ((np.abs(g0[k]) > SMALL_GRAD * np.sqrt(np.mean(
            np.square(g0[k])))) | (g0[k] == 0))
        assert _rel_l2(got[k][fixed], want[k][fixed]) <= GRAD_TOL, k
        assert (np.abs(got[k] - want[k])[~fixed] <= 2 * lr).all(), k
    got, want = _flat(to1.mu), _flat(jo1.mu)
    assert max(_rel_l2(got[k], want[k]) for k in want) <= GRAD_TOL


@pytest.mark.parametrize("arch", ("recurrentgemma-9b", "whisper-small"))
def test_tensor_parallel_refuses_the_hybrid_and_encdec_families(arch):
    """Kept under its name from before their tensor parallelism was
    ported: over a model axis of 2 the tp profile's step makers now
    build, ``train_shardings`` cuts what the reference's rules match
    (the hybrid's ``embed`` by vocab and ``unembed`` on d_model, every
    other leaf whole; whisper's ``w_in`` by columns and ``w_out`` by
    rows, its embedding by vocab at 512, every attention leaf whole),
    and ``cache_shardings`` cuts the hybrid's state and conv window by
    width with its one-head KV ring whole, and whisper's self and cross
    K/V by heads. The dp profile cuts nothing."""
    cfg = treg.reduced_config(treg.get_config(arch))
    sizes = {"data": 1, "model": 2}
    for make in (tsteps.make_prefill_step, tsteps.make_serve_step):
        assert callable(make(cfg, mesh=sizes, device="cpu"))
    p_sh, _ = tsteps.train_shardings(cfg, sizes)
    specs = {"/".join(p): sh.spec for p, sh in tree_leaves_with_path(p_sh)}
    cut = {k for k, v in specs.items() if v}
    if cfg.is_encdec:
        assert cut == {"embed", "enc_blocks/w_in", "enc_blocks/w_out",
                       "blocks/w_in", "blocks/w_out"}
        assert specs["blocks/w_in"] == (None, None, "model")
        assert specs["blocks/w_out"] == (None, "model")
        p = te.init_params(cfg, device="cpu")
        cache = te.init_decode_cache(p, cfg, torch.zeros(
            (2, cfg.encoder_seq, cfg.d_model)))
        want = dict.fromkeys(("k", "v", "xk", "xv"),
                             (None, None, None, "model"))
    else:
        assert cut == {"embed", "unembed"}
        cache = th.init_decode_cache(cfg, 2, 8, device="meta")
        want = {"lru_h": (None, None, "model"),
                "conv": (None, None, None, "model"), "k": (), "v": ()}
    assert specs["embed"] == ("model",)
    c_sh = tsteps.cache_shardings(cache, sizes)
    assert {k: getattr(c_sh, k).spec for k in want} == want
    assert c_sh.length.spec == ()
    dp, _ = tsteps.train_shardings(cfg, {"data": 1, "model": 2},
                                   profile="dp")
    assert all(not sh.spec for _, sh in tree_leaves_with_path(dp))
