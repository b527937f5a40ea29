"""mamba2 in the port (``repro_torch.models.ssm``, its config, registry
and the serving step makers) against the JAX package, at the
reference's reduced size (``reduced_config``: 4 layers, d_model 64,
state 16, head dim 8, chunk 16, vocab 512).

Both packages compute on the same weights: the JAX ``init_params`` tree
crosses through ``convert.ssm_params_from_numpy``; other inputs are
numpy draws from a seed. On the CPU the JAX ``forward`` takes the plain
conv (it takes the Pallas kernel only on a TPU) and ``ssm_block(...,
use_pallas_conv=True)`` runs the Pallas kernel in interpret mode; the
port's wrapper takes its plain version on a CPU tensor.

Tolerances, relative to the largest |reference value|: 1e-5 in float32
(the same sums in other orders: XLA's and PyTorch's matmuls and
einsums; 2.2e-6 is the largest seen on the logits), 2e-2 in bfloat16
(the reference's own for bf16 kernels, ``tests/test_kernels.py:125``;
XLA on the CPU keeps some intermediates in float32 where PyTorch rounds
each op to bfloat16; 4.9e-3, one bf16 step, is the largest seen). The
port's decode against its own forward is held at the reference's 5e-4
absolute (``tests/test_system.py:85``).
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
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr

ROOT = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ARCH = "mamba2-780m"


def _cfgs(dtype="float32"):
    """(JAX cfg, port cfg): the reduced mamba2 in ``dtype``."""
    j = dataclasses.replace(jreg.reduced_config(jreg.get_config(ARCH)),
                            dtype=dtype)
    t = dataclasses.replace(treg.reduced_config(treg.get_config(ARCH)),
                            dtype=dtype)
    return j, t


def _params(jcfg, seed=0):
    """(JAX params, the same weights as port tensors on the CPU)."""
    params = jssm.init_params(jcfg, jax.random.PRNGKey(seed))
    return params, convert.ssm_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"
    )


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


# --- config and registry -------------------------------------------------------


def test_config_and_registry_match_the_reference():
    j, t = jreg.get_config(ARCH), treg.get_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.n_layers, t.d_model, t.ssm_state, t.ssm_head_dim, t.ssm_expand,
            t.ssm_conv_kernel, t.ssm_chunk, t.vocab, t.dtype) == (
        48, 1536, 128, 64, 2, 4, 256, 50280, "bfloat16")
    assert (t.d_inner, t.ssm_n_heads, t.n_params()) == (
        j.d_inner, j.ssm_n_heads, j.n_params())
    assert dataclasses.asdict(treg.reduced_config(t)) == dataclasses.asdict(
        jreg.reduced_config(j))
    assert {k: dataclasses.asdict(v) for k, v in treg.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jreg.SHAPES.items()}
    assert set(treg.ARCH_IDS) == set(jreg.ARCH_IDS)
    for arch in set(treg.ARCH_IDS) - {ARCH}:
        with pytest.raises(NotImplementedError, match="A13"):
            treg.get_config(arch)
        with pytest.raises(NotImplementedError, match="A13"):
            treg.get_model(jreg.get_config(arch))


def test_init_params_has_the_reference_shapes_and_casts():
    jcfg, tcfg = _cfgs()
    want = jax.eval_shape(lambda k: jssm.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    got = tssm.init_params(tcfg, seed=0, device="cpu")
    jflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    tflat = {}
    for k, v in got.items():
        for k2, v2 in (v.items() if isinstance(v, dict) else [(None, v)]):
            name = f"['{k}']" + (f"['{k2}']" if k2 else "")
            tflat[name] = v2
    assert set(jflat) == set(tflat)
    for name, v in jflat.items():
        assert tuple(tflat[name].shape) == v.shape, name
        assert tflat[name].dtype == torch.float32
    # cast_params casts the same leaves to the compute dtype as the
    # reference's (and keeps the others as they are, whatever JAX's
    # default float: another test file may have enabled x64).
    jcast = jax.eval_shape(lambda t: jtr.cast_params(t, jnp.bfloat16),
                           want["blocks"])
    tcast = ttr.cast_params(got["blocks"], "bfloat16")
    for k, v in jcast.items():
        assert (tcast[k].dtype == torch.bfloat16) == (v.dtype == jnp.bfloat16), k
    assert {k for k, v in tcast.items() if v.dtype != torch.bfloat16} == {
        "ln1", "A_log", "dt_bias", "ssm_norm"}


# --- SSD core ------------------------------------------------------------------


def _ssd_inputs(b=2, l=32, h=4, p=8, g=2, n=16, seed=0, state=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dA = -np.abs(rng.standard_normal((b, l, h))).astype(np.float32) * 0.3
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if state else None
    return x, dA, B, C, s0


def _both(arrays):
    jx = [None if a is None else jnp.asarray(a) for a in arrays]
    tx = [None if a is None else torch.from_numpy(a) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("state", (False, True))
@pytest.mark.parametrize("g", (1, 2))
def test_ssd_chunked_matches_jax(g, state):
    (jx, jdA, jB, jC, js0), (tx, tdA, tB, tC, ts0) = _both(
        _ssd_inputs(g=g, state=state))
    jy, jfin = jssm.ssd_chunked(jx, jdA, jB, jC, 8, initial_state=js0)
    ty, tfin = tssm.ssd_chunked(tx, tdA, tB, tC, 8, initial_state=ts0)
    assert _rel(ty, jy) <= TOL["float32"]
    assert _rel(tfin, jfin) <= TOL["float32"]
    with pytest.raises(ValueError, match="divisible"):
        tssm.ssd_chunked(tx, tdA, tB, tC, 12)


@pytest.mark.parametrize("state", (False, True))
def test_ssd_sequential_matches_jax_and_the_chunked_form(state):
    (jx, jdA, jB, jC, js0), (tx, tdA, tB, tC, ts0) = _both(
        _ssd_inputs(g=2, state=state, seed=1))
    jy, jfin = jssm.ssd_sequential(jx, jdA, jB, jC, initial_state=js0)
    ty, tfin = tssm.ssd_sequential(tx, tdA, tB, tC, initial_state=ts0)
    assert _rel(ty, jy) <= TOL["float32"]
    assert _rel(tfin, jfin) <= TOL["float32"]
    cy, cfin = tssm.ssd_chunked(tx, tdA, tB, tC, 16, initial_state=ts0)
    assert _rel(cy, ty) <= TOL["float32"]
    assert _rel(cfin, tfin) <= TOL["float32"]


# --- block, forward, decode ----------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("use_pallas_conv", (True, False))
def test_ssm_block_matches_jax(use_pallas_conv, dtype):
    """Layer 1 of the reduced model on (2, 32) inputs; the JAX side runs
    the Pallas conv in interpret mode when ``use_pallas_conv``."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, seed=1)
    jblk = jtr.cast_params(jax.tree.map(lambda a: a[1], jp["blocks"]),
                           jcfg.dtype)
    tblk = ttr.cast_params({k: v[1] for k, v in tp["blocks"].items()},
                           tcfg.dtype)
    x = np.random.default_rng(2).standard_normal((2, 32, 64))
    xj = jnp.asarray(x, jcfg.dtype)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(
        getattr(torch, dtype))
    want = jssm.ssm_block(xj, jblk, jcfg, use_pallas_conv)
    got = tssm.ssm_block(xt, tblk, tcfg, use_pallas_conv)
    assert got.dtype == xt.dtype
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_forward_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    tokens = _tokens(2, 32, jcfg.vocab)
    want, _ = jssm.forward(jp, jcfg, jnp.asarray(tokens))
    got, aux = tssm.forward(tp, tcfg, torch.from_numpy(tokens))
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0.0
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_decode_step_matches_jax(dtype):
    """Three decode steps from an empty cache: logits and every part of
    the cache."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, seed=2)
    tokens = _tokens(2, 3, jcfg.vocab, seed=3)
    jc = jssm.init_decode_cache(jcfg, 2, 16)
    tc = tssm.init_decode_cache(tcfg, 2, 16, device="cpu")
    for t in range(3):
        jl, jc = jssm.decode_step(jp, jcfg, jnp.asarray(tokens[:, t:t + 1]), jc)
        tl, tc = tssm.decode_step(tp, tcfg, torch.from_numpy(tokens[:, t:t + 1]),
                                  tc)
        assert tl.shape == (2, jcfg.vocab)
        assert _rel(tl, jl) <= TOL[dtype]
    assert tc.conv.dtype == tc.state.dtype == torch.float32
    assert _rel(tc.conv, jc.conv) <= TOL[dtype]
    assert _rel(tc.state, jc.state) <= TOL[dtype]
    assert int(tc.length) == int(jc.length) == 3


def test_decode_matches_forward():
    """``tests/test_system.py:67`` on the port: step-by-step decode
    reproduces the teacher-forced logits, here over two SSD chunks."""
    _, tcfg = _cfgs()
    params = tssm.init_params(tcfg, seed=3, device="cpu")
    tokens = torch.from_numpy(_tokens(2, 32, tcfg.vocab, seed=4))
    full, _ = tssm.forward(params, tcfg, tokens)
    cache = tssm.init_decode_cache(tcfg, 2, 32, device="cpu")
    errs = []
    for t in range(32):
        lg, cache = tssm.decode_step(params, tcfg, tokens[:, t:t + 1], cache)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 5e-4, errs


# --- step makers and the serving entry point -----------------------------------


def test_prefill_and_serve_steps():
    _, tcfg = _cfgs()
    params = tssm.init_params(tcfg, seed=5, device="cpu")
    tokens = torch.from_numpy(_tokens(2, 16, tcfg.vocab, seed=5))
    last = make_prefill_step(tcfg, device="cpu")(params, {"tokens": tokens})
    full, _ = tssm.forward(params, tcfg, tokens)
    assert last.dtype == torch.float32
    assert torch.equal(last, full[:, -1].float())
    plain = make_prefill_step(tcfg, device="cpu", use_pallas_conv=False)
    assert torch.equal(plain(params, {"tokens": tokens}), last)
    step = make_serve_step(tcfg, device="cpu")
    cache = tssm.init_decode_cache(tcfg, 2, 16, device="cpu")
    lg, cache = step(params, cache, {"tokens": tokens[:, :1]})
    assert lg.dtype == torch.float32 and lg.shape == (2, tcfg.vocab)
    assert int(cache.length) == 1


def test_serve_runs_on_the_cpu_and_refuses_what_it_lacks():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--batch", "2", "--steps", "4"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert out.returncode == 0, out.stderr
    assert "generated (2, 5) tokens" in out.stdout
    with pytest.raises(NotImplementedError, match="A9"):
        tserve.main(["--reduced", "--device", "cpu", "--auto-tune"])
    with pytest.raises(NotImplementedError, match="A13"):
        tserve.main(["--arch", "whisper-small", "--device", "cpu"])
    _, tcfg = _cfgs()
    toks, secs = tserve.serve(tcfg, batch=3, steps=2, device="cpu", seed=1)
    assert toks.shape == (3, 3) and secs > 0
    assert int(toks.min()) >= 0 and int(toks.max()) < tcfg.vocab
    again, _ = tserve.serve(tcfg, batch=3, steps=2, device="cpu", seed=1)
    assert torch.equal(toks, again)  # seeded: init, start tokens, samples


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_forward_on_card_launches_b7_once_per_layer(cuda_device, dtype):
    jcfg, tcfg = _cfgs(dtype)
    tp = convert.ssm_params_from_numpy(
        jax.tree.map(np.asarray, jssm.init_params(jcfg, jax.random.PRNGKey(0))),
        device=cuda_device)
    tokens = torch.from_numpy(_tokens(2, 32, jcfg.vocab)).to(cuda_device)
    kc.reset_launch_counts()
    got, _ = tssm.forward(tp, tcfg, tokens)
    assert kc.conv1d_depthwise_cuda.launches == tcfg.n_layers
    plain, _ = tssm.forward(tp, tcfg, tokens, use_pallas_conv=False)
    assert kc.conv1d_depthwise_cuda.launches == tcfg.n_layers
    # B7 rounds as the plain conv does, so the logits agree exactly.
    assert torch.equal(got, plain)
