"""The dense transformer family in the port (``repro_torch.models.layers``
and ``models.transformer``, the five configs, the registry and the
serving steps) against the JAX package: qwen2.5-3b, qwen2.5-14b,
gemma-2b, llama3-8b and qwen2-vl-7b at the reference's reduced size
(``reduced_config``: 4 layers, d_model 64, 4 heads of 16, d_ff 128,
vocab 512; the VLM's 8 patches and M-RoPE sections (2, 3, 3)).

Both packages compute on the same weights: the JAX ``init_params`` tree
crosses through ``convert.model_params_from_numpy``; other inputs are
numpy draws from a seed. The reference computes every layer in plain
``jnp`` (no Pallas kernel), so nothing here runs in interpret mode.

Tolerances, max |port − ref| / max |ref|: 1e-5 in float32 (the same
sums in other orders), 2e-2 in bfloat16 (the reference's own for bf16,
``tests/test_kernels.py:125``: XLA on the CPU keeps some intermediates
in float32 where PyTorch rounds each op). Decode against the port's own
forward is held at the reference's 5e-4 absolute
(``tests/test_system.py:85``).
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
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.kernels import emit
from repro_torch.kernels import xcorr1d as kx
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import (
    make_grad_step,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.tree import tree_leaves_with_path

ROOT = Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DECODE_TOL = 5e-4
DENSE = ("qwen2.5-3b", "qwen2.5-14b", "gemma-2b", "llama3-8b",
         "qwen2-vl-7b")
MOE = ("mixtral-8x7b", "qwen3-moe-30b-a3b")


@pytest.fixture(autouse=True)
def _f32_reference_and_two_threads():
    """The reference in JAX's default float32, whatever another test file
    set, and torch on two threads (the test workers share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with jax.enable_x64(False):
            yield
    finally:
        torch.set_num_threads(threads)


def _cfgs(arch, **kw):
    """(JAX cfg, port cfg): the reduced ``arch`` with ``kw``."""
    j = dataclasses.replace(jreg.reduced_config(jreg.get_config(arch)), **kw)
    t = dataclasses.replace(treg.reduced_config(treg.get_config(arch)), **kw)
    return j, t


def _params(jcfg, seed=0):
    """(JAX params, the same weights as port tensors on the CPU)."""
    params = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return params, convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of ``a`` in ``dtype``, equal values."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(dtype), t


def _inputs(cfg, b, s, seed=0):
    """(tokens, {"positions", "patch_embeds"} for the VLM) as numpy: the
    VLM's three M-RoPE streams differ (time, then a row and a column of
    an image grid) so each section sees its own angles."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s))
    extra = {}
    if cfg.family == "vlm":
        t = np.broadcast_to(np.arange(s), (b, s))
        extra["positions"] = np.stack([t, t // 3, t % 3]).astype(np.int32)
        extra["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return tokens, extra


def _to_jax(extra):
    return {k: jnp.asarray(v) for k, v in extra.items()}


def _to_torch(extra):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in extra.items()}


# --- layers ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 5000, (2, 12))
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 16, 5e5)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 16, 5e5)
    assert tc.dtype == torch.float32 and tc.shape == (2, 12, 8)
    assert _rel(tc, jc) <= TOL["float32"] and _rel(ts, js) <= TOL["float32"]
    jx, tx = _pair(rng.standard_normal((2, 12, 3, 16)), dtype)
    got = tl.apply_rope(tx, tc, ts)
    assert got.dtype == tx.dtype
    assert _rel(got, jl.apply_rope(jx, jc, js)) <= TOL[dtype]


def test_mrope_matches_reference():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 64, (3, 2, 10))
    jc, js = jl.mrope_cos_sin(jnp.asarray(pos), 16, 1e6, (2, 3, 3))
    tc, ts = tl.mrope_cos_sin(torch.from_numpy(pos), 16, 1e6, (2, 3, 3))
    assert tc.shape == (2, 10, 8)
    assert _rel(tc, jc) <= TOL["float32"] and _rel(ts, js) <= TOL["float32"]
    # each band follows its own stream: the time band is stream 0's
    want, _ = tl.rope_cos_sin(torch.from_numpy(pos[0]), 16, 1e6)
    assert torch.equal(tc[..., :2], want[..., :2])
    with pytest.raises(ValueError, match="sum to head_dim"):
        tl.mrope_cos_sin(torch.from_numpy(pos), 16, 1e6, (2, 3, 4))


def _qkv(b, s, t, h, g, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return (_pair(rng.standard_normal((b, s, h, dh)), dtype),
            _pair(rng.standard_normal((b, t, g, dh)), dtype),
            _pair(rng.standard_normal((b, t, g, dh)), dtype))


def test_expand_kv_repeats_each_group_in_place():
    kv = torch.arange(2 * 3 * 2 * 1, dtype=torch.float32).reshape(2, 3, 2, 1)
    got = tl.expand_kv(kv, 6)
    want = np.asarray(jl.expand_kv(jnp.asarray(kv.numpy()), 6))
    assert np.array_equal(got.numpy(), want)
    assert tl.expand_kv(kv, 2) is kv


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("window", (None, 5))
@pytest.mark.parametrize("s,t", ((12, 12), (4, 12)))
def test_attention_matches_reference(s, t, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, s, t, 4, 2, 16, dtype, 2)
    got = tl.attention(tq, tk, tv, causal=True, window=window)
    want = jl.attention(jq, jk, jv, causal=True, window=window)
    assert got.dtype == tq.dtype
    assert _rel(got, want) <= TOL[dtype]


CHUNKED = {
    "causal": dict(),
    "noncausal": dict(causal=False),
    "window": dict(window=11),
    "banded": dict(window=8, q_chunk=4, kv_chunk=8),
    "banded-unroll": dict(window=8, q_chunk=4, kv_chunk=8, unroll=True),
    "skip-unroll": dict(unroll=True, skip_masked_blocks=True),
}


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_attention_matches_reference(case, dtype):
    kw = dict(q_chunk=8, kv_chunk=8) | CHUNKED[case]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 32, 32, 4, 1, 16, dtype, 3)
    got = tl.chunked_attention(tq, tk, tv, **kw)
    want = jl.chunked_attention(jq, jk, jv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _rel(got, want) <= TOL[dtype]
    if case != "noncausal":  # the same function as the materialised form
        plain = tl.attention(tq.float(), tk.float(), tv.float(),
                             window=kw.get("window"))
        assert _rel(got, plain) <= TOL[dtype]


def test_chunked_attention_refuses_ragged_chunks():
    t = torch.zeros((1, 12, 2, 4))
    with pytest.raises(ValueError, match="chunk sizes must divide"):
        tl.chunked_attention(t, t, t, q_chunk=8, kv_chunk=4)
    with pytest.raises(ValueError, match="q_chunk | kv_chunk"):
        tl.chunked_attention(t, t, t, window=4, q_chunk=3, kv_chunk=4)


@pytest.mark.parametrize("window", (None, 3))
@pytest.mark.parametrize("cache_len", (1, 7, 10))
def test_decode_attention_matches_reference(cache_len, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 1, 10, 4, 2, 16, "float32", 4)
    got = tl.decode_attention(tq, tk, tv, torch.tensor(cache_len),
                              window=window)
    want = jl.decode_attention(jq, jk, jv, jnp.asarray(cache_len),
                               window=window)
    assert _rel(got, want) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("kind", ("swiglu", "geglu"))
def test_gated_mlp_matches_reference(kind, dtype):
    rng = np.random.default_rng(5)
    (jx, tx), (jg, tg), (ju, tu), (jd, td) = (
        _pair(rng.standard_normal(s) * 0.3, dtype)
        for s in ((2, 6, 16), (16, 24), (16, 24), (24, 16)))
    got = tl.gated_mlp(tx, tg, tu, td, kind)
    assert got.dtype == tx.dtype
    assert _rel(got, jl.gated_mlp(jx, jg, ju, jd, kind)) <= TOL[dtype]
    with pytest.raises(ValueError):
        tl.gated_mlp(tx, tg, tu, td, "relu")


def test_gelu_mlp_and_layer_norm_match_reference():
    rng = np.random.default_rng(6)
    arrs = [_pair(rng.standard_normal(s), "float32") for s in
            ((2, 6, 16), (16, 24), (24,), (24, 16), (16,), (16,))]
    (jx, tx), (jw, tw), (jb, tb), (jo, to), (jbo, tbo), (jg, tg) = arrs
    assert _rel(tl.gelu_mlp(tx, tw, tb, to, tbo),
                jl.gelu_mlp(jx, jw, jb, jo, jbo)) <= TOL["float32"]
    assert _rel(tl.layer_norm(tx, tg, tbo),
                jl.layer_norm(jx, jg, jbo)) <= TOL["float32"]


# --- configs and registry ----------------------------------------------------


def test_registry_matches_the_reference():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert set(treg.ARCH_MODULES) == set(DENSE) | set(MOE) | {
        "mamba2-780m", "recurrentgemma-9b", "whisper-small"}
    for arch in treg.ARCH_MODULES:
        j, t = jreg.get_config(arch), treg.get_config(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), arch
        assert t.n_params() == j.n_params(), arch
        assert dataclasses.asdict(treg.reduced_config(t)) == \
            dataclasses.asdict(jreg.reduced_config(j)), arch
        assert treg.uses_fsdp(arch) == jreg.uses_fsdp(arch), arch
    assert treg.uses_fsdp("qwen2.5-14b") and not treg.uses_fsdp("llama3-8b")
    with pytest.raises(KeyError):
        treg.get_config("gpt-2")


@pytest.mark.parametrize("arch,item", (
    ("recurrentgemma-9b", "hybrid.py"), ("whisper-small", "encdec.py")))
def test_unported_families_raise_naming_their_roadmap_item(arch, item):
    """The two families the registry refused until their port (the
    hybrid, ``models/hybrid.py``; the encoder-decoder,
    ``models/encdec.py``): ``get_config``, ``n_params``, ``uses_fsdp``
    and ``reduced_config`` equal the reference's, and ``get_model``
    gives that module's API, as the reference's registry does."""
    import importlib

    j, t = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.n_params() == j.n_params()
    assert treg.uses_fsdp(arch) == jreg.uses_fsdp(arch)
    assert dataclasses.asdict(treg.reduced_config(t)) == \
        dataclasses.asdict(jreg.reduced_config(j))
    module = importlib.import_module(
        f"repro_torch.models.{item.removesuffix('.py')}")
    api, japi = treg.get_model(t), jreg.get_model(j)
    for name in japi._fields:
        assert getattr(api, name) is getattr(module, name), name
    assert api.abstract_params is module.abstract_params


@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_and_model_api_match_the_reference(arch):
    """The MoE archs (refused before their port): ``get_config`` and
    ``reduced_config`` equal the reference's field for field, and
    ``get_model`` gives the transformer's API, as the reference's
    registry does for the ``moe`` family."""
    j, t = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert dataclasses.asdict(treg.reduced_config(t)) == \
        dataclasses.asdict(jreg.reduced_config(j))
    small = treg.reduced_config(t)
    assert (small.n_experts, small.top_k, small.d_ff_expert) == (8, 2, 96)
    api = treg.get_model(t)
    assert api.forward is ttr.forward and api.lm_loss is ttr.lm_loss
    assert treg.uses_fsdp(arch) == jreg.uses_fsdp(arch)


def test_ffn_block_on_the_moe_family_returns_the_reference_aux():
    """``ffn_block`` of an MoE config runs ``moe_ffn`` on ``blk["moe"]``:
    the output and the router's aux loss equal the reference's."""
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    jp, tp = _params(jcfg, seed=5)
    jblk = jax.tree.map(lambda v: v[0], jp["blocks"])
    tblk = {"moe": {k: v[0] for k, v in tp["blocks"]["moe"].items()}}
    x = np.random.default_rng(5).standard_normal(
        (2, 10, tcfg.d_model)).astype(np.float32)
    want, jaux = jtr.ffn_block(jnp.asarray(x), jblk, jcfg)
    got, aux = ttr.ffn_block(torch.from_numpy(x), tblk, tcfg)
    assert _rel(got, want) <= TOL["float32"]
    assert abs(float(aux) - float(jaux)) <= 1e-6 * float(jaux)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", DENSE)
def test_params_have_the_reference_shapes(arch):
    """The full config's abstract tree against the reference's (every
    leaf, the optional ones included), and the reduced init's leaves,
    dtypes and the zero leaves."""
    want = jspecs.abstract_params(jreg.get_config(arch))
    got = ttr.abstract_params(treg.get_config(arch))
    flat = {"/".join(p): tuple(v.shape)
            for p, v in tree_leaves_with_path(got)}
    assert all(v.device.type == "meta" for _, v in tree_leaves_with_path(got))
    assert flat == {
        "/".join(str(k.key) for k in path): tuple(v.shape)
        for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    jcfg, tcfg = _cfgs(arch)
    params = ttr.init_params(tcfg, seed=0, device="cpu")
    small = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                           jax.random.PRNGKey(0))
    assert {"/".join(p): tuple(v.shape)
            for p, v in tree_leaves_with_path(params)} == {
        "/".join(str(k.key) for k in path): tuple(v.shape)
        for path, v in jax.tree_util.tree_flatten_with_path(small)[0]}
    for path, v in tree_leaves_with_path(params):
        assert v.dtype == torch.float32, path
        if path[-1] in ("ln1", "ln2", "final_norm", "bq", "bk", "bv"):
            assert not v.any(), path
    # seeded: the same seed gives the same draws
    again = ttr.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(again["blocks"]["wq"], params["blocks"]["wq"])
    assert ("unembed" in params) == (not tcfg.tie_embeddings)


def test_cast_params_keeps_norms_f32():
    _, cfg = _cfgs("qwen2.5-3b")
    blk = ttr.init_params(cfg, seed=0, device="cpu")["blocks"]
    cast = ttr.cast_params(blk, "bfloat16")
    for k, v in cast.items():
        want = torch.float32 if k in ("ln1", "ln2") else torch.bfloat16
        assert v.dtype == want, k


# --- forward, decode ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp, tp = _params(jcfg, seed=1)
    tokens, extra = _inputs(jcfg, 2, 24, seed=1)
    want, jaux = jax.jit(jtr.forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(tokens), **_to_jax(extra))
    got, aux = ttr.forward(tp, tcfg, torch.from_numpy(tokens),
                           **_to_torch(extra))
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0.0
    assert _rel(got, want) <= TOL[dtype]
    if arch == "qwen2-vl-7b":  # the patches and M-RoPE streams matter
        other, _ = ttr.forward(tp, tcfg, torch.from_numpy(tokens))
        assert _rel(other, want) > 10 * TOL[dtype]


def _decode_against_reference(jcfg, tcfg, steps, max_len, seed):
    """The port's and the JAX ``decode_step`` from empty caches over the
    same ``steps`` tokens: (worst logits error, worst cache error), and
    the port's logits and last cache."""
    jp, tp = _params(jcfg, seed=seed)
    tokens, _ = _inputs(jcfg, 2, steps, seed=seed)
    jstep = jax.jit(jtr.decode_step, static_argnums=1)
    jcache = jtr.init_decode_cache(jcfg, 2, max_len)
    tcache = ttr.init_decode_cache(tcfg, 2, max_len, device="cpu")
    assert tcache.k.shape == jcache.k.shape
    logit_err, cache_err, logits = 0.0, 0.0, []
    for i in range(steps):
        jl_, jcache = jstep(jp, jcfg, jnp.asarray(tokens[:, i:i + 1]), jcache)
        tl_, tcache = ttr.decode_step(
            tp, tcfg, torch.from_numpy(tokens[:, i:i + 1]), tcache)
        logits.append(tl_)
        logit_err = max(logit_err, _rel(tl_, jl_))
        cache_err = max(cache_err, _rel(tcache.k, jcache.k),
                        _rel(tcache.v, jcache.v))
        assert int(tcache.length) == int(jcache.length) == i + 1
    return logit_err, cache_err, tp, tokens, torch.stack(logits, 1)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference_and_forward(arch):
    """12 decode steps (logits and both caches) against the JAX
    ``decode_step``; and against the port's own forward within the
    reference's 5e-4."""
    jcfg, tcfg = _cfgs(arch)
    logit_err, cache_err, tp, tokens, logits = _decode_against_reference(
        jcfg, tcfg, 12, 16, seed=2)
    assert logit_err <= TOL["float32"] and cache_err <= TOL["float32"]
    full, _ = ttr.forward(tp, tcfg, torch.from_numpy(tokens))
    assert float((logits - full).abs().max()) < DECODE_TOL


def test_ring_cache_matches_reference_past_the_window():
    """qwen2.5-3b with an 8-token window and max_len 16: a ring of 8
    slots, overwritten from step 9 on; decode against the JAX ring and
    against the port's windowed forward."""
    jcfg, tcfg = _cfgs("qwen2.5-3b", sliding_window=8)
    logit_err, cache_err, tp, tokens, logits = _decode_against_reference(
        jcfg, tcfg, 12, 16, seed=3)
    assert logit_err <= TOL["float32"] and cache_err <= TOL["float32"]
    cache = ttr.init_decode_cache(tcfg, 2, 16, device="cpu")
    assert cache.k.shape[2] == 8
    full, _ = ttr.forward(tp, tcfg, torch.from_numpy(tokens))
    assert float((logits - full).abs().max()) < DECODE_TOL
    # the window matters: without it the later logits differ
    nowin = dataclasses.replace(tcfg, sliding_window=None)
    other, _ = ttr.forward(tp, nowin, torch.from_numpy(tokens))
    assert float((other[:, 9:] - full[:, 9:]).abs().max()) > 10 * DECODE_TOL


def test_decode_cache_dtype_follows_the_config():
    _, cfg = _cfgs("llama3-8b", dtype="bfloat16")
    cache = ttr.init_decode_cache(cfg, 2, 16, device="cpu")
    assert cache.k.dtype == cache.v.dtype == torch.bfloat16
    assert cache.k.shape == (4, 2, 16, 1, 16)
    assert cache.length.dtype == torch.int32 and int(cache.length) == 0
    f32 = ttr.init_decode_cache(cfg, 2, 16, dtype="float32", device="cpu")
    assert f32.k.dtype == torch.float32


def test_forward_at_4096_crosses_the_chunked_branch(monkeypatch):
    """One layer at width 64 on s = 4096: the streaming form on chunks
    of 1024, as the reference's dispatch takes it above 2048."""
    jcfg, tcfg = _cfgs("llama3-8b", n_layers=1)
    jp, tp = _params(jcfg, seed=4)
    tokens, _ = _inputs(jcfg, 1, 4096, seed=4)
    calls = []
    chunked = tl.chunked_attention

    def counting(*a, **kw):
        calls.append((kw["q_chunk"], kw["kv_chunk"]))
        return chunked(*a, **kw)

    monkeypatch.setattr(tl, "chunked_attention", counting)
    want, _ = jax.jit(jtr.forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(tokens))
    got, _ = ttr.forward(tp, tcfg, torch.from_numpy(tokens))
    assert calls == [(1024, 1024)]
    assert _rel(got, want) <= TOL["float32"]


def test_banded_dispatch_with_a_window_dividing_the_sequence(monkeypatch):
    """s = 2560 > 2048 with a window of 512 dividing it: the banded form
    (KV chunk = window), as the reference dispatches it."""
    jcfg, tcfg = _cfgs("qwen2.5-3b", n_layers=1, sliding_window=512)
    jp, tp = _params(jcfg, seed=5)
    tokens, _ = _inputs(jcfg, 1, 2560, seed=5)
    calls = []
    chunked = tl.chunked_attention

    def counting(*a, **kw):
        calls.append((kw["q_chunk"], kw["kv_chunk"], kw["window"]))
        return chunked(*a, **kw)

    monkeypatch.setattr(tl, "chunked_attention", counting)
    want, _ = jax.jit(jtr.forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(tokens))
    got, _ = ttr.forward(tp, tcfg, torch.from_numpy(tokens))
    assert calls == [(512, 512, 512)]
    assert _rel(got, want) <= TOL["float32"]


# --- steps and the serving entry point ---------------------------------------


def _counts():
    return (kc.conv1d_depthwise_cuda.launches, emit.fused_stencil_swc.launches,
            kx.xcorr1d_cuda.launches)


def test_prefill_and_serve_steps_carry_the_vlm_inputs():
    jcfg, tcfg = _cfgs("qwen2-vl-7b")
    _, tp = _params(jcfg, seed=6)
    tokens, extra = _inputs(jcfg, 2, 16, seed=6)
    batch = {"tokens": torch.from_numpy(tokens), **_to_torch(extra)}
    last = make_prefill_step(tcfg, device="cpu")(tp, batch)
    full, _ = ttr.forward(tp, tcfg, batch["tokens"], **_to_torch(extra))
    assert last.dtype == torch.float32
    assert torch.equal(last, full[:, -1].float())
    lg, cache = make_serve_step(tcfg, device="cpu")(
        tp, ttr.init_decode_cache(tcfg, 2, 16, device="cpu"),
        {"tokens": batch["tokens"][:, :1]})
    assert lg.dtype == torch.float32 and lg.shape == (2, tcfg.vocab)
    assert int(cache.length) == 1


def test_dense_steps_refuse_a_conv_switch_and_launch_no_kernel():
    """The transformer has no conv: a dense step asked for mamba2's
    switch raises instead of ignoring it; and the dense path launches
    none of B1-B7 (on the CPU the wrappers would count too)."""
    _, cfg = _cfgs("llama3-8b")
    params = ttr.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long),
             "labels": torch.zeros((1, 8), dtype=torch.long)}
    for make in (make_prefill_step, make_grad_step):
        with pytest.raises(TypeError, match="use_pallas_conv"):
            make(cfg, device="cpu", use_pallas_conv=True)(params, batch)
    kc.reset_launch_counts()
    emit.reset_launch_counts()
    kx.reset_launch_counts()
    make_prefill_step(cfg, device="cpu")(params, batch)
    make_grad_step(cfg, device="cpu")(params, batch)
    assert _counts() == (0, 0, 0)


def test_dense_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, cfg = _cfgs("llama3-8b")
    for call in (
        lambda: ttr.init_params(cfg),
        lambda: ttr.init_decode_cache(cfg, 1, 8),
        lambda: make_prefill_step(cfg),
        lambda: tserve.serve(cfg, batch=1, steps=1),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_serve_cli_runs_a_dense_model_on_the_cpu(capsys):
    tserve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                 "--batch", "2", "--steps", "4"])
    assert "generated (2, 5) tokens" in capsys.readouterr().out
    _, cfg = _cfgs("gemma-2b")
    toks, secs = tserve.serve(cfg, batch=3, steps=3, device="cpu", seed=1)
    assert toks.shape == (3, 4) and secs > 0
    again, _ = tserve.serve(cfg, batch=3, steps=3, device="cpu", seed=1)
    assert torch.equal(toks, again)


def test_serve_cli_in_a_fresh_interpreter_imports_no_jax():
    code = ("import json, sys\n"
            "from repro_torch.launch import serve\n"
            "serve.main(['--arch', 'qwen2-vl-7b', '--reduced', '--device', "
            "'cpu', '--batch', '1', '--steps', '2'])\n"
            "print(json.dumps([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "generated (1, 3) tokens" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[]"
