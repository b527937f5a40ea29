"""The port's cell matrix, input specs, LM traffic model, roofline and
dry run (``repro_torch.configs.registry.cell_status``/``all_cells``,
``launch/specs.py``, ``core/trafficmodel.modeled_hbm_bytes``,
``core/rooflinelib.py``, ``launch/dryrun.py``) against the JAX
package's.

* The 40-cell matrix and its skip strings equal the reference's, string
  for string; ``input_specs`` of every cell has the reference's shapes,
  its dtypes mapped one to one (the ids ``int32`` → ``int64``,
  ``bfloat16`` as it is); the abstract optimizer-state and decode-cache
  trees equal the reference's ``jax.eval_shape`` trees at each arch's
  reduced config.
* ``modeled_hbm_bytes`` equals the reference's within 1e-12 relative for
  every cell's shape, every kind and meshes 1x1, 2x2, 16x16 and
  2x16x16, FSDP as the arch's ``uses_fsdp`` (pure Python on both
  sides).
* The roofline terms mirror ``tests/test_core.py``'s on the H100's
  data-sheet rates.
* The dry run's FLOP count of one step on meta tensors equals the count
  of the same step run on CPU tensors (``FlopCounterMode`` on both) at
  the reduced configs, one arch of each family and each kind; its
  layer extrapolation equals the full-depth count on a fake 2x2 mesh,
  where the useful-FLOP share stays at or below 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import rooflinelib as jrl
from repro.core import trafficmodel as jtm
from repro.launch import specs as jspecs
from repro.models import encdec as jenc
from repro_torch.configs import registry as treg
from repro_torch.core import rooflinelib as rl
from repro_torch.core import trafficmodel as tm
from repro_torch.core.trafficmodel import modeled_hbm_bytes
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.tree import tree_leaves_with_path

CELLS = [(a, s) for a in jreg.ARCH_IDS for s in jreg.SHAPES]
# the inputs' dtypes: the ids int32 → the port's int64
DTYPES = {jnp.dtype("int32"): torch.int64,
          jnp.dtype("bfloat16"): torch.bfloat16,
          jnp.dtype("float32"): torch.float32}
# the state trees' dtypes: the same
TREE_DTYPES = {jnp.dtype("int32"): torch.int32,
               jnp.dtype("bfloat16"): torch.bfloat16,
               jnp.dtype("float32"): torch.float32}
# one arch of each family
FAMILIES = ("qwen2.5-3b", "mixtral-8x7b", "qwen2-vl-7b", "mamba2-780m",
            "recurrentgemma-9b", "whisper-small")


@pytest.fixture(autouse=True)
def _f32_reference():
    with jax.enable_x64(False):
        yield


def test_cell_matrix_is_the_references():
    assert treg.SUBQUADRATIC == jreg.SUBQUADRATIC
    assert treg.all_cells() == jreg.all_cells()
    statuses = [st for _, _, st in treg.all_cells()]
    assert len(statuses) == 40 and statuses.count("run") == 32


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_have_the_references_shapes(arch, shape):
    want = jspecs.input_specs(arch, jreg.SHAPES[shape])
    got = S.input_specs(arch, treg.SHAPES[shape])
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == DTYPES[jnp.dtype(w.dtype)], k


def _leaves(tree) -> dict:
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        out[key] = (tuple(v.shape), jnp.dtype(v.dtype))
    return out


def _torch_leaves(tree) -> dict:
    return {"/".join(p): (tuple(v.shape), v.dtype)
            for p, v in tree_leaves_with_path(tree)}


def _same_tree(got: dict, want: dict):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, (shape, dtype) in want.items():
        assert got[k][0] == shape, k
        assert got[k][1] == TREE_DTYPES[dtype], k


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_abstract_trees_match_the_references_eval_shape(arch):
    """``abstract_opt_state`` and ``abstract_decode_cache`` at the reduced
    config (a decode shape of 2 rows and 64 tokens) against
    ``jax.eval_shape`` of the reference's ``adamw_init`` and
    ``init_decode_cache`` (whisper's from encoder outputs, its
    ``init_decode_cache``'s own signature)."""
    jcfg = jreg.reduced_config(jreg.get_config(arch))
    tcfg = treg.reduced_config(treg.get_config(arch))
    shape = treg.ShapeSpec("tiny", 64, 2, "decode")
    jparams = jspecs.abstract_params(jcfg)
    jopt = jspecs.abstract_opt_state(jparams)
    topt = S.abstract_opt_state(S.abstract_params(tcfg))
    assert topt.step.device.type == "meta"
    assert (tuple(topt.step.shape), topt.step.dtype) == ((), torch.int32)
    for part in ("mu", "nu"):
        _same_tree(_torch_leaves(getattr(topt, part)),
                   _leaves(getattr(jopt, part)))
    if jcfg.is_encdec:
        enc = jax.ShapeDtypeStruct((2, jcfg.encoder_seq, jcfg.d_model),
                                   jnp.bfloat16)
        jcache = jax.eval_shape(
            lambda p, e: jenc.init_decode_cache(p, jcfg, e), jparams, enc)
    else:
        jcache = jspecs.abstract_decode_cache(
            jcfg, jreg.ShapeSpec("tiny", 64, 2, "decode"))
    tcache = S.abstract_decode_cache(tcfg, shape)
    want = {k: (tuple(v.shape), jnp.dtype(v.dtype))
            for k, v in jcache._asdict().items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in tcache._asdict().items()
           if v is not None}
    _same_tree(got, want)


MESHES = [(1, 1, 1), (1, 2, 2), (1, 16, 16), (2, 16, 16)]


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_modeled_hbm_bytes_equal_the_references(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    fsdp = jreg.uses_fsdp(arch)
    assert treg.uses_fsdp(arch) == fsdp
    for shape in jreg.SHAPES.values():
        for kind in ("train", "prefill", "decode"):
            for pod, data, model in MESHES:
                kw = dict(model_ways=model, dp_ways=pod * data, fsdp=fsdp)
                want = jtm.modeled_hbm_bytes(jcfg, kind, shape.seq_len,
                                             shape.global_batch, **kw)
                got = modeled_hbm_bytes(tcfg, kind, shape.seq_len,
                                        shape.global_batch, **kw)
                assert got == pytest.approx(want, rel=1e-12, abs=0), (
                    shape.name, kind, (pod, data, model))


def test_roofline_terms_and_dominance():
    r = rl.Roofline(flops=1e13, hbm_bytes=1e10, collective_wire_bytes=1e9,
                    chips=256, hw=rl.H100_SXM5)
    assert r.compute_s == pytest.approx(1e13 / 989e12)
    assert r.memory_s == pytest.approx(1e10 / 3.35e12)
    assert r.collective_s == pytest.approx(1e9 / 450e9)
    assert r.dominant == "compute"
    assert 0 < r.roofline_fraction(0.5e13) <= 1.0
    assert r.useful_flops_fraction(0.5e13) == pytest.approx(0.5)
    f32 = rl.Roofline(flops=67e12, hbm_bytes=0.0, collective_wire_bytes=0.0,
                      chips=1, dtype_bytes=4)
    assert f32.compute_s == pytest.approx(1.0)


def test_machine_balance_and_the_card_rates_are_the_traffic_models():
    hw = rl.H100_SXM5
    assert hw.machine_balance(2) == pytest.approx(989e12 / 3.35e12)
    assert hw.machine_balance(4) == pytest.approx(67e12 / 3.35e12)
    assert hw.hbm_bw == tm.CARD_RATES["H100"][0]
    assert hw.peak_flops_f32 == tm.CARD_RATES["H100"][1]
    assert hw.peak_flops_bf16 == tm.TC_RATES["bfloat16"]
    assert (hw.link_bw, hw.hbm_bytes, hw.smem_bytes, hw.tdp_watts) == (
        450e9, 80 * 10**9, 227 * 1024, 700.0)


def test_model_flops_and_stencil_bounds_match_the_reference():
    for n, d in ((3.1e9, 1e6), (7.0, 13.0)):
        assert rl.model_flops_train(n, d) == jrl.model_flops_train(n, d)
        assert rl.model_flops_decode(n, d) == jrl.model_flops_decode(n, d)
    assert rl.stencil_ideal_bytes(512**3, 1, 1, 4) == \
        jrl.stencil_ideal_bytes(512**3, 1, 1, 4) == 2 * 512**3 * 4
    assert rl.stencil_mxu_roof_s(989e12, dtype_bytes=2) == pytest.approx(1.0)
    assert rl.stencil_mxu_roof_s(67e12, dtype_bytes=4) == pytest.approx(1.0)


def test_collective_stats_read_comms_counts():
    stats = rl.collective_stats({"all_reduce": 3, "all_gather": 1,
                                 "bytes": 1234})
    assert stats.counts == {"all-reduce": 3, "all-gather": 1}
    assert stats.total_wire_bytes == 1234


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_flop_count_equals_the_cpu_steps(arch, kind):
    """One step at the reduced config, 2 rows of 32 tokens (whisper: its
    encoder frames and target), counted on meta stand-ins and on seeded
    CPU tensors: the same FLOPs, and none zero."""
    cfg = treg.reduced_config(treg.get_config(arch))
    shape = treg.ShapeSpec("tiny", 32, 2, kind)
    counts = []
    for device, seed in (("meta", None), ("cpu", 0)):
        run, resident = dryrun.build_cell(cfg, shape, device=device,
                                          seed=seed)
        counts.append((dryrun.count_flops(run)[0], resident))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0


@pytest.mark.parametrize("arch,shape", [
    ("qwen2.5-3b", "train_4k"), ("mixtral-8x7b", "decode_32k"),
    ("recurrentgemma-9b", "decode_32k"), ("whisper-small", "prefill_32k")])
def test_extrapolated_counts_equal_the_full_depth_on_a_fake_mesh(arch,
                                                                  shape):
    """At the reduced config on a fake (data 2, model 2) group: the
    layer extrapolation gives the full-depth step's FLOPs and collective
    calls and bytes, the cell's records agree but for them, and the
    useful-FLOP share is at most 1 (but at whisper's prefill, where the
    reference's model FLOPs count all parameters, the decoder's too, for
    each encoder frame). mixtral's decode groups span the two data ranks
    (64 tokens a rank of a global group of 128)."""
    cfg = treg.reduced_config(treg.get_config(arch))
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, n_layers=8)  # 2 super-blocks + tail
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        full = dryrun.analyze_cell(arch, shape, mesh, cfg_override=cfg,
                                   full_depth=True)
        extra = dryrun.analyze_cell(arch, shape, mesh, cfg_override=cfg)
    assert extra["flops_per_chip"] == pytest.approx(full["flops_per_chip"],
                                                    rel=1e-9)
    assert extra["coll_wire_bytes"] == pytest.approx(
        full["coll_wire_bytes"], rel=1e-9)
    assert extra["coll_counts"] == full["coll_counts"]
    assert full["coll_counts"], "a 2x2 mesh runs collectives"
    for k in ("hbm_bytes_modeled_per_chip", "resident_bytes_per_chip",
              "model_flops_per_chip", "n_params", "chips"):
        assert extra[k] == full[k], k
    assert full["useful_flops_ratio"] > 0
    if arch != "whisper-small":
        assert full["useful_flops_ratio"] <= 1.0
    assert full["dominant"] in ("compute", "memory", "collective")
