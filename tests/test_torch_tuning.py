"""The port's tuner (``repro_torch.tuning``) on the CPU, held against the
JAX package's (``repro.tuning``): the key grammar and ``cache_id``
equal over a grid, ``plan_from_record`` round trips, the cache cases of
``tests/test_tuning.py`` (round trip, cross-process key, schema bump,
merge, the quarantines, concurrent ``put``, failed rows), the session
with an injected ``measure``, and the Hopper cost model: every
candidate a launch the planner makes, today's hand-set tiles in its top
4 at the shapes they were swept at. On the CPU ``"auto"`` resolves by
the model alone (``source="model"``, backend ``cpu``)."""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.kernels import plan as jplan
from repro.tuning import cache as jcache
from repro.tuning import session as jsession
from repro_torch.core.stencil import OperatorSet, derivative_operator_set
from repro_torch.ft import faults as ftfaults
from repro_torch.ft.faults import FaultInjector, FaultSpec
from repro_torch.kernels import plan as kplan
from repro_torch.kernels.ops import _max_threads_of, _slots_of
from repro_torch.physics.diffusion import DiffusionProblem
from repro_torch.physics.mhd import (
    RHS_PHI_FLOPS,
    SUBSTEP_PHI_FLOPS,
    MHDSolver,
    mhd_rhs_device_phi,
    mhd_substep_device_phi,
)
from repro_torch.tuning import (
    SCHEMA_VERSION,
    TuningCache,
    TuningKey,
    TuningRecord,
    TuningSession,
    current_backend,
    enumerate_candidates_nd,
    enumerate_cross_strategy_nd,
    fused_nd_key,
)
from repro_torch.tuning import session as sess_mod
from repro_torch.tuning.costmodel import NonFiniteOutput

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
CPU = "cpu"

KEY = TuningKey(
    kernel="fused_stencil3d", strategy="swc", domain=(8, 8, 16),
    radii=(1, 1, 1), n_f=2, n_out=1, dtype="float32", backend="cpu",
)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path))
    return tmp_path


def _subprocess_env(cache_dir) -> dict:
    env = dict(os.environ)
    env["REPRO_TORCH_TUNE_CACHE"] = str(cache_dir)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _cands():
    """Model-ranked candidates of a small 3-D problem (KEY's shape)."""
    ops = derivative_operator_set(3, 2, spacing=0.3)
    return enumerate_candidates_nd(ops, (8, 8, 16), 2, 1)


# --- the key: equal to the reference's ------------------------------------------


GRID = list(itertools.product(
    ("swc", "swc_stream", "tc", "auto", "hwc"), (1, 2, 3), (1, 2),
    (1, 2, 3, "auto"), (1, 4), (0, 2, 4, 6, 8), (0, 1),
))


def test_strategy_sid_and_cache_id_equal_the_reference():
    for strategy, rank, unroll, depth, batch, acc, n_aux in GRID:
        args = (strategy, rank, unroll, depth, batch, acc, n_aux)
        assert kplan.strategy_sid(*args) == jplan.strategy_sid(*args), args
        domain = (8, 12, 16)[-rank:]
        radii = (1, 2, 3)[-rank:]
        kw = dict(backend="cpu", unroll=unroll, fuse_steps=depth,
                  batch=batch, accuracy=acc, n_aux=n_aux)
        ours = fused_nd_key(domain, radii, 2, 2, "float32", strategy, **kw)
        theirs = jsession.fused_nd_key(domain, radii, 2, 2, "float32",
                                       strategy, **kw)
        assert ours.cache_id == theirs.cache_id, args


@pytest.mark.parametrize("strategy,rank,depth,batch,n_aux", [
    ("swc", 1, 1, 1, 0), ("swc", 2, 2, 1, 0), ("swc", 3, 1, 3, 1),
    ("swc_stream", 2, 1, 1, 0), ("swc_stream", 3, 2, 2, 0),
    ("tc", 2, 1, 1, 0), ("tc", 3, 2, 1, 0), ("tc", 1, 1, 2, 1),
])
def test_plan_from_record_round_trips_strategy_id(strategy, rank, depth,
                                                  batch, n_aux):
    """A record of the plan the probe makes reconstructs a plan with the
    same ``strategy_id``, tile and depth, and that id is the one the
    reference's ``plan_from_record`` gives for the same record."""
    domain = (16, 24, 32)[-rank:]
    t_ops = derivative_operator_set(rank, 4, spacing=0.5)
    n_f = 1
    n_out = n_f + n_aux if depth > 1 else 1
    lead = (batch,) if batch > 1 else ()
    padded = lead + (n_f,) + tuple(n + 2 * 2 * depth for n in domain)
    probe = kplan.plan_stencil(t_ops, padded, n_out, strategy=strategy,
                               n_aux=n_aux, fuse_steps=depth)
    rec = TuningRecord(
        block=probe.block, timings_us={}, source="model", fuse_steps=depth,
        stream=strategy == "swc_stream", strategy_resolved=strategy,
    )
    interior = lead + (n_f,) + domain
    plan = kplan.plan_from_record(t_ops, interior, n_out, rec, n_aux=n_aux)
    assert plan.strategy_id == probe.strategy_id
    assert (plan.block, plan.fuse_steps) == (probe.block, depth)
    assert plan.tuning_key("cpu").cache_id == probe.tuning_key("cpu").cache_id
    from repro.core.stencil import derivative_operator_set as jdos

    jrec = jcache.TuningRecord.from_json(rec.to_json())
    jp = jplan.plan_from_record(jdos(rank, 4, spacing=0.5), interior, n_out,
                                jrec, n_aux=n_aux)
    assert jp.strategy_id == plan.strategy_id
    hwc = dataclasses.replace(rec, strategy_resolved="hwc")
    assert kplan.plan_from_record(t_ops, interior, n_out, hwc) is None


@pytest.mark.parametrize("stream,batch,depth", [
    (False, 1, 1), (False, 4, 2), (True, 1, 3), (True, 8, 1),
])
def test_traffic_terms_equal_the_reference(stream, batch, depth):
    """The tuner's traffic terms: the batched per-member bytes (with no
    launch-overhead constant: the reference's at 0) and the fused
    traffic reduction."""
    from repro.core import trafficmodel as jtm
    from repro_torch.core import trafficmodel as ttm

    args = ((64, 96, 128), (8, 16, 32), (3, 3, 3), 2, 2, 4)
    ours = ttm.stencil_batched_hbm_bytes_per_member_step(
        *args, batch=batch, fuse_steps=depth, stream=stream)
    theirs = jtm.stencil_batched_hbm_bytes_per_member_step(
        *args, batch=batch, fuse_steps=depth, stream=stream,
        launch_overhead_bytes=0.0)
    assert ours == pytest.approx(theirs, rel=1e-12)
    kw = dict(block_base=(8, 16, 32), block_fused=(4, 32, 32),
              fuse_steps=depth + 1, stream=stream)
    assert ttm.stencil_traffic_reduction(
        (64, 96, 128), (3, 3, 3), 2, 2, 4, **kw) == pytest.approx(
        jtm.stencil_traffic_reduction((64, 96, 128), (3, 3, 3), 2, 2, 4,
                                      **kw), rel=1e-12)


def test_backend_and_cache_dir_are_the_ports_own(tmp_path, monkeypatch):
    assert current_backend(CPU) == "cpu"
    assert current_backend(torch.device("cpu")) == "cpu"
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert TuningCache().dir == tmp_path / "xdg" / "repro-torch-tune"
    assert jcache.TuningCache().dir == tmp_path / "jax"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "ours"))
    assert TuningCache().file == tmp_path / "ours" / "cache.json"


# --- cache ---------------------------------------------------------------------


def test_cache_roundtrip_persistence(cache_dir):
    rec = TuningRecord(
        block=(4, 8, 16), timings_us={"4x8x16": 12.5, "8x8x16": 17.0},
        source="measured",
    )
    TuningCache().put(KEY, rec)
    got = TuningCache().get(KEY)  # a fresh view re-reads the disk
    assert got is not None
    assert got.block == (4, 8, 16)
    assert got.timings_us == rec.timings_us
    assert got.source == "measured"
    assert got.schema == SCHEMA_VERSION
    assert got.created > 0
    # The same file is the reference's layout: its cache reads it too.
    jgot = jcache.TuningCache(cache_dir).get(
        jcache.TuningKey(**dataclasses.asdict(KEY)))
    assert jgot is not None and jgot.block == (4, 8, 16)


def test_cache_key_stable_across_processes(cache_dir):
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('c', sys.argv[1])\n"
        "c = importlib.util.module_from_spec(spec)\n"
        "sys.modules['c'] = c\n"
        "spec.loader.exec_module(c)\n"
        "print(c.TuningKey(kernel='fused_stencil3d', strategy='swc',"
        " domain=(8, 8, 16), radii=(1, 1, 1), n_f=2, n_out=1,"
        " dtype='float32', backend='cpu').cache_id)\n"
    )
    module = str(Path(SRC) / "repro_torch" / "tuning" / "cache.py")
    out = subprocess.run(
        [sys.executable, "-c", code, module], capture_output=True,
        text=True, env=_subprocess_env(cache_dir), check=True,
    )
    assert out.stdout.strip() == KEY.cache_id


def test_schema_bump_invalidates_records(cache_dir):
    TuningCache().put(
        KEY, TuningRecord(block=(4, 8, 16), timings_us={}, source="model")
    )
    path = cache_dir / "cache.json"
    raw = json.loads(path.read_text())
    for rec in raw["records"].values():
        rec["schema"] = SCHEMA_VERSION - 1
    path.write_text(json.dumps(raw))
    assert TuningCache().get(KEY) is None


def test_cache_put_merges_with_disk(cache_dir):
    a, b = TuningCache(), TuningCache()
    key2 = TuningKey(
        kernel="xcorr1d", strategy="baseline:u1", domain=(1024,),
        radii=(2,), n_f=1, n_out=1, dtype="float32", backend="cpu",
    )
    a.put(KEY, TuningRecord(block=(8, 8, 16), timings_us={}, source="model"))
    b.put(key2, TuningRecord(block=2048, timings_us={}, source="model"))
    fresh = TuningCache()
    assert fresh.get(KEY) is not None
    assert fresh.get(key2).block == 2048  # an int block stays an int


def _seed_cache(cache_dir):
    TuningCache().put(
        KEY, TuningRecord(block=(4, 8, 16), timings_us={}, source="measured")
    )
    return cache_dir / "cache.json"


@pytest.mark.parametrize("damage", ["truncate", "garbage", "layout"])
def test_corrupt_cache_is_quarantined_and_rebuilt(cache_dir, damage):
    """A cache.json cut short, garbled, or valid JSON of another layout
    is renamed aside (not shadowed), its bytes kept, and the next put
    starts clean."""
    path = _seed_cache(cache_dir)
    data = path.read_bytes()
    bad = {
        "truncate": data[: len(data) // 2],
        "garbage": b"{garbage: definitely, not json\x00",
        "layout": b'["not", "a", "cache", "document"]',
    }[damage]
    path.write_bytes(bad)
    fresh = TuningCache()
    assert fresh.get(KEY) is None
    corpse = cache_dir / "cache.json.corrupt"
    assert corpse.read_bytes() == bad and not path.exists()
    fresh.put(KEY, TuningRecord(block=(8, 8, 16), timings_us={},
                                source="measured"))
    assert TuningCache().get(KEY).block == (8, 8, 16)


def test_repeated_corruption_numbers_the_corpses(cache_dir):
    for _ in range(3):
        path = _seed_cache(cache_dir)
        path.write_text("not json at all")
        assert TuningCache().get(KEY) is None
    names = sorted(p.name for p in cache_dir.glob("cache.json.corrupt*"))
    assert names == [
        "cache.json.corrupt", "cache.json.corrupt.1", "cache.json.corrupt.2",
    ]


def test_missing_cache_is_cold_start_not_corruption(cache_dir):
    assert TuningCache().get(KEY) is None
    assert list(cache_dir.glob("cache.json.corrupt*")) == []


# The cache module alone (no torch import: a few ms a process).
_STRESS_WORKER = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("tuning_cache", sys.argv[2])
cache_mod = importlib.util.module_from_spec(spec)
sys.modules["tuning_cache"] = cache_mod
spec.loader.exec_module(cache_mod)
worker = int(sys.argv[1])
cache = cache_mod.TuningCache()
for i in range(6):
    key = cache_mod.TuningKey(
        kernel="stress", strategy=f"w{worker}", domain=(i,),
        radii=(1,), n_f=1, n_out=1, dtype="float32", backend="cpu",
    )
    cache.put(key, cache_mod.TuningRecord(
        block=2 ** (i + 4), timings_us={}, source="measured"))
"""


def test_multiprocess_put_loses_no_record(cache_dir):
    """Processes putting at once (tiny records): the file lock and the
    read-merge-write keep every record of every worker."""
    n_workers = 3
    module = str(Path(SRC) / "repro_torch" / "tuning" / "cache.py")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _STRESS_WORKER, str(w), module],
            env=_subprocess_env(cache_dir),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for w in range(n_workers)
    ]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    items = TuningCache().items()
    for w in range(n_workers):
        for i in range(6):
            key_id = f"stress|w{w}|{i}|1|1|1|float32|cpu"
            assert items[key_id].block == 2 ** (i + 4), key_id


# --- session (an injected measure) ----------------------------------------------


def test_session_cache_hit_skips_measurement(cache_dir):
    cands = _cands()
    calls = []

    def measure(cand):
        calls.append(cand.block)
        return 1.0 if cand.block != cands[0].block else 0.5

    sess = TuningSession(top_k=2)
    rec1 = sess.tune(KEY, cands, measure)
    assert rec1.source == "measured" and len(calls) == 2
    rec2 = sess.tune(KEY, lambda: pytest.fail("enumerated on a hit"),
                     measure)
    assert len(calls) == 2 and rec2.block == rec1.block


def test_session_upgrades_model_record_when_measurable(cache_dir):
    cands = _cands()
    sess = TuningSession(top_k=2)
    assert sess.tune(KEY, cands, measure=None).source == "model"
    calls = []

    def measure(cand):
        calls.append(cand.block)
        return 1.0

    assert sess.tune(KEY, cands, measure).source == "measured"
    assert len(calls) == 2
    assert sess.tune(KEY, cands, measure).source == "measured"
    assert len(calls) == 2


def test_session_all_discarded_raises(cache_dir):
    """A search whose every kernel candidate was refused records no
    winner: it raises, and nothing is persisted."""
    cands = _cands()

    def measure(cand):
        raise RuntimeError("kernel launch failed: CUDA error 9 "
                           "(invalid configuration argument)")

    with pytest.raises(RuntimeError, match="no kernel candidate"):
        TuningSession().tune(KEY, cands, measure)
    assert TuningCache().get(KEY) is None


def _cross_cands():
    """The strategy='auto' space of a small 2-D problem: hwc plus the
    kernels."""
    ops = derivative_operator_set(2, 2, spacing=0.3)
    return enumerate_cross_strategy_nd(ops, (64, 64), 1, 1)


def test_build_failure_of_every_kernel_raises_rather_than_plain_wins(
        cache_dir):
    """A kernel that fails to build is a fault of the program, not a
    discarded launch: the search re-raises rather than let the timed
    plain version win and be replayed on the card."""
    cands = _cross_cands()
    assert any(c.strategy == "hwc" for c in cands)

    def measure(cand):
        if cand.strategy == "hwc":
            return 1.0
        raise RuntimeError("nvcc failed (1) building fused_stencil.cu:")

    with pytest.raises(RuntimeError, match="nvcc failed"):
        TuningSession().tune(KEY, cands, measure,
                             pinned=lambda c: c.strategy == "hwc")
    assert TuningCache().get(KEY) is None


def test_plain_baseline_wins_only_a_space_without_kernels(cache_dir):
    """hwc is timed beside the kernels but, on the card, wins only where
    the space holds no kernel candidate; if every kernel was refused the
    search raises."""
    cands = _cross_cands()
    timed = []

    def measure(cand):
        timed.append(cand.strategy)
        return 0.5 if cand.strategy == "hwc" else 1.0

    rec = TuningSession().tune(KEY, cands, measure,
                               pinned=lambda c: c.strategy == "hwc")
    assert "hwc" in timed and rec.resolved_strategy != "hwc"
    label = next(k for k in rec.timings_us if k.startswith("hwc"))
    assert rec.timings_us[label] < rec.timings_us[rec.winner_label]

    def refused(cand):
        if cand.strategy == "hwc":
            return 0.5
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(RuntimeError, match="no kernel candidate"):
        TuningSession().tune(KEY, cands, refused, force=True,
                             pinned=lambda c: c.strategy == "hwc")
    only_plain = [c for c in cands if c.strategy == "hwc"]
    rec = TuningSession().tune(KEY, only_plain, lambda c: 0.5, force=True)
    assert rec.resolved_strategy == "hwc" and rec.source == "measured"


def test_session_measures_pinned_candidates_beyond_top_k(cache_dir):
    """The planner's own tile (and in the cross-strategy search hwc)
    is timed even where the model ranks it out of the top k."""
    cands = _cands()
    default = next(i for i, c in enumerate(cands) if c.default)
    calls = []
    sess = TuningSession(top_k=1)
    sess.tune(KEY, cands, lambda c: calls.append(c) or 1.0,
              pinned=lambda c: c.default)
    assert cands[0] in calls and cands[default] in calls
    assert len(calls) == (1 if default == 0 else 2)


@pytest.mark.parametrize("err,discarded", [
    (RuntimeError("fused_stencil kernel launch failed: CUDA error 700 (an "
                  "illegal memory access was encountered)"), False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
    (RuntimeError("nvcc failed (1) building fused_stencil.cu:"), False),
    (TypeError("fused_stencil_nd() got an unexpected keyword"), False),
    (ValueError("staged working set exceeds the shared memory"), False),
    (RuntimeError("fused_stencil kernel launch failed: CUDA error 9 "
                  "(invalid configuration argument)"), True),
    (RuntimeError("xcorr1d kernel launch failed: CUDA error 7 (too many "
                  "resources requested for launch)"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (ftfaults.InjectedCompileFailure("tune.candidate", "boom"), True),
    (NonFiniteOutput("candidate produced non-finite output"), True),
])
def test_only_clean_refusals_become_failed_rows(cache_dir, err, discarded):
    """A clean refusal of one candidate is a failed row; anything else
    re-raises: a sticky CUDA error poisons the context, and a build
    failure or a Python error is a fault of the program — catching either
    would hide it behind the next candidate."""
    assert sess_mod.discarded_launch(err) is discarded
    calls = []

    def measure(cand):
        calls.append(cand)
        if len(calls) == 1:
            raise err
        return 1.0

    if discarded:
        rec = TuningSession(top_k=2).tune(KEY, _cands(), measure)
        assert len(rec.failed) == 1 and rec.source == "measured"
    else:
        with pytest.raises(type(err)):
            TuningSession(top_k=2).tune(KEY, _cands(), measure)
        assert TuningCache().get(KEY) is None


def test_failed_candidates_recorded_and_skipped_on_retune(cache_dir):
    cands = _cands()
    bad = {cands[0].block}
    calls = []

    def measure(cand):
        calls.append(cand.block)
        if cand.block in bad:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 1.0

    rec = TuningSession(top_k=2).tune(KEY, cands, measure)
    assert rec.source == "measured" and rec.block != cands[0].block
    assert len(rec.failed) == 1
    assert "OutOfMemoryError" in next(iter(rec.failed.values()))
    assert len(TuningCache().get(KEY).failed) == 1  # persisted
    calls.clear()
    rec2 = TuningSession(top_k=2).tune(KEY, cands, measure, force=True)
    assert cands[0].block not in calls and len(calls) == 2
    assert rec2.failed == rec.failed


def test_failed_rows_roundtrip_and_old_records_parse(cache_dir):
    rec = TuningRecord(
        block=(4, 8, 16), timings_us={"4x8x16": 9.0}, source="measured",
        failed={"8x8x16": "InjectedCompileFailure: boom"},
    )
    TuningCache().put(KEY, rec)
    assert TuningCache().get(KEY).failed == rec.failed
    d = rec.to_json()
    del d["failed"]
    assert TuningRecord.from_json(d).failed == {}


def test_injected_candidate_fault_lands_in_failed_rows(cache_dir):
    """The module-level active injector (the chaos seam) turns a
    targeted candidate fault into a failed row, and tuning resolves."""
    inj = FaultInjector([
        FaultSpec("tune.candidate", "compile", label="*", times=1),
    ])
    with ftfaults.active(inj):
        assert ftfaults.get_active() is inj
        rec = TuningSession(top_k=2).tune(KEY, _cands(), lambda c: 1.0)
    assert ftfaults.get_active() is None
    assert rec.source == "measured" and len(rec.failed) == 1
    assert "InjectedCompileFailure" in next(iter(rec.failed.values()))
    assert inj.fired[0][0] == "tune.candidate"


# --- "auto" call sites on the CPU -----------------------------------------------


def test_auto_block_resolves_by_model_and_replays_across_processes(
        cache_dir):
    """block="auto" on a CPU tensor: a model record under the cpu
    backend, the output equal to the explicit launch; a second process
    replays the record (no new record, nothing measured)."""
    from repro_torch.core.fusion import FusedStencilOp
    from repro_torch.kernels.phi import select_phi

    ops = derivative_operator_set(3, 2, spacing=0.3)
    f = torch.randn(2, 8, 8, 16, generator=torch.Generator().manual_seed(7))
    before = sess_mod.MEASURE_COUNT
    out = FusedStencilOp(ops, select_phi("dxx"), 2, strategy="swc",
                         block="auto", device=CPU)(f)
    explicit = FusedStencilOp(ops, select_phi("dxx"), 2, strategy="swc",
                              device=CPU)(f)
    assert torch.equal(out, explicit) and sess_mod.MEASURE_COUNT == before
    (key, rec), = TuningCache().items().items()
    assert key.startswith("fused_stencil3d|swc:o2|8x8x16|") and key.endswith(
        "|cpu")
    assert rec.source == "model" and rec.timings_us == {}
    code = """
import torch
from repro_torch.core.fusion import FusedStencilOp
from repro_torch.core.stencil import derivative_operator_set
from repro_torch.kernels.phi import select_phi
from repro_torch.tuning import TuningCache, session
ops = derivative_operator_set(3, 2, spacing=0.3)
f = torch.randn(2, 8, 8, 16, generator=torch.Generator().manual_seed(7))
before = TuningCache().items()
FusedStencilOp(ops, select_phi("dxx"), 2, strategy="swc", block="auto",
               device="cpu")(f)
assert session.MEASURE_COUNT == 0 and TuningCache().items() == before
print("REPLAYED")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_subprocess_env(cache_dir))
    assert res.returncode == 0, res.stderr
    assert "REPLAYED" in res.stdout


def test_1d_auto_keys_equal_the_reference(cache_dir):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.conv1d_depthwise import DEFAULT_BLOCK_SEQ

    f = torch.randn(4096 + 4, generator=torch.Generator().manual_seed(3))
    g = torch.randn(5, generator=torch.Generator().manual_seed(4))
    assert torch.equal(kops.xcorr1d(f, g, block_size="auto"),
                       kops.xcorr1d(f, g))
    x = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(5))
    w = torch.randn(4, 16, generator=torch.Generator().manual_seed(6))
    assert torch.equal(kops.conv1d_depthwise(x, w, block_seq="auto"),
                       kops.conv1d_depthwise(x, w))
    keys = set(TuningCache().items())
    assert keys == {
        jcache.TuningKey("xcorr1d", "baseline:u4", (4096,), (4,), 1, 1,
                         "float32", "cpu").cache_id,
        jcache.TuningKey("conv1d_depthwise", "none", (2, 64, 16), (3,), 1,
                         1, "float32", "cpu").cache_id,
    }
    conv = [r for k, r in TuningCache().items().items() if "conv1d" in k][0]
    assert conv.block == DEFAULT_BLOCK_SEQ and conv.source == "model"


def test_enable_auto_routes_model_call_sites(cache_dir, monkeypatch):
    from repro_torch.kernels import ops as kops

    monkeypatch.setattr(sess_mod, "AUTO_ENABLED", False)
    x = torch.randn(1, 32, 8, generator=torch.Generator().manual_seed(8))
    w = torch.randn(4, 8, generator=torch.Generator().manual_seed(9))
    kops.conv1d_depthwise(x, w)
    assert TuningCache().items() == {}
    sess_mod.enable_auto()
    assert torch.equal(kops.conv1d_depthwise(x, w),
                       kops.conv1d_depthwise(x, w, block_seq=512))
    assert len(TuningCache().items()) == 1


def test_per_bucket_tuning_cache_hits(cache_dir):
    """SimServer(block="auto"): the first batch of each bucket writes a
    ``:b{B}``-keyed record (the model's, on the CPU); a fresh server
    replays them, writing none."""
    from repro_torch.launch.serve_sim import SimServer, demo_queue

    server = SimServer(strategy="swc", block="auto", max_batch=2,
                       device=CPU)
    server.serve(demo_queue([(16, 32), (12, 24)], 2, 8, device=CPU))
    keys = set(TuningCache().items())
    assert len(keys) == 2 and all(":b2" in k for k in keys)
    fresh = SimServer(strategy="swc", block="auto", max_batch=2, device=CPU)
    fresh.serve(demo_queue([(16, 32), (12, 24)], 2, 8, device=CPU))
    assert set(TuningCache().items()) == keys


def test_cli_warm_show_clear(cache_dir, capsys):
    from repro_torch.tuning.cli import main

    assert main(["warm", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAILED" not in out and "0 measurement(s) taken" in out
    assert main(["show"]) == 0
    shown = capsys.readouterr().out
    assert "auto:sauto:fauto" in shown and "[model]" in shown
    assert main(["clear"]) == 0
    assert TuningCache().items() == {}


# --- the Hopper cost model -------------------------------------------------------


def _diffusion_ops(shape) -> OperatorSet:
    p = DiffusionProblem(shape, accuracy=6)
    return OperatorSet((dataclasses.replace(p.merged_stencil(),
                                            name="step"),))


@pytest.mark.parametrize("rank,strategy,depth,batch,n_aux", [
    (1, "swc", 1, 1, 0), (1, "tc", 2, 1, 0), (2, "swc_stream", 1, 2, 0),
    (2, "swc", 3, 1, 0), (3, "tc", 1, 1, 1), (3, "swc_stream", 2, 1, 0),
    (3, "swc", 2, 2, 0),
])
def test_every_candidate_is_a_launch_the_planner_makes(rank, strategy,
                                                        depth, batch, n_aux):
    """Each enumerated candidate re-plans to itself (the planner accepts
    its tile and keeps it), and no two candidates are one launch."""
    domain = (32, 48, 64)[-rank:]
    ops = derivative_operator_set(rank, 4, spacing=0.5)
    n_out = 1 + n_aux if depth > 1 else 1
    cands = enumerate_candidates_nd(
        ops, domain, 1, n_out, strategies=(strategy,),
        fuse_steps_options=(depth,), batch=batch, n_aux=n_aux)
    assert cands and sum(c.default for c in cands) == 1
    lead = (batch,) if batch > 1 else ()
    seen = set()
    for c in cands:
        padded = lead + (1,) + tuple(n + 4 * depth for n in domain)
        plan = kplan.plan_stencil(ops, padded, n_out, strategy=strategy,
                                  block=c.block, n_aux=n_aux,
                                  fuse_steps=depth)
        assert plan.block == c.block and plan.smem_bytes == c.smem_bytes
        assert plan.smem_bytes <= kplan.SMEM_PER_BLOCK
        assert (c.strategy, c.fuse_steps, c.block) not in seen
        seen.add((c.strategy, c.fuse_steps, c.block))


def test_cross_strategy_space_follows_the_reference_rules():
    ops = _diffusion_ops((64, 128))
    both = enumerate_cross_strategy_nd(ops, (64, 128), 1, 1,
                                       fuse_steps_options=(1, 2))
    assert {c.strategy for c in both} == {"hwc", "swc", "swc_stream", "tc"}
    assert sum(c.strategy == "hwc" for c in both) == 1
    f64 = enumerate_cross_strategy_nd(ops, (64, 128), 1, 1, "float64")
    assert "tc" not in {c.strategy for c in f64}
    r1 = enumerate_cross_strategy_nd(_diffusion_ops((4096,)), (4096,), 1, 1)
    assert "swc_stream" not in {c.strategy for c in r1}
    aux = enumerate_cross_strategy_nd(ops, (64, 128), 1, 2, n_aux=1)
    assert "swc_stream" not in {c.strategy for c in aux}
    plain = enumerate_cross_strategy_nd(ops, (64, 128), 1, 1,
                                        kernels_ok=False)
    assert [c.strategy for c in plain] == ["hwc"]
    # The plain version, one pass per tap, loses to the kernels at the
    # main path's size; the kernels' wave quantisation leaves it the
    # winner on a domain of a few tiles.
    big = _diffusion_ops((8192, 8192))
    assert enumerate_cross_strategy_nd(
        big, (8192, 8192), 1, 1)[0].strategy != "hwc"
    small = enumerate_cross_strategy_nd(_diffusion_ops((16, 32)), (16, 32),
                                        1, 1)
    assert small[0].strategy == "hwc"


HAND_SET = [
    # (shape, strategy, depth, tile): the planner's tiles, each swept on
    # the card at this shape (PERF.md section 6).
    ((512,) * 3, "swc", 1, (8, 16, 32)),
    ((512,) * 3, "swc_stream", 1, (8, 16, 32)),
    ((512,) * 3, "tc", 1, (8, 8, 32)),
    ((512,) * 3, "swc", 2, (4, 32, 32)),
    ((512,) * 3, "swc", 3, (2, 32, 32)),
    ((8192, 8192), "swc", 1, (64, 64)),
    ((8192, 8192), "swc_stream", 1, (32, 128)),
    ((8192, 8192), "tc", 1, (32, 64)),
    ((1 << 26,), "swc", 1, (1024,)),
    ((1 << 26,), "tc", 1, (512,)),
]


@pytest.mark.parametrize("shape,strategy,depth,tile", HAND_SET)
def test_model_ranks_the_hand_set_diffusion_tiles_in_its_top_4(
        shape, strategy, depth, tile):
    cands = enumerate_candidates_nd(
        _diffusion_ops(shape), shape, 1, 1, strategies=(strategy,),
        fuse_steps_options=(depth,), operators=("step",))
    blocks = [c.block for c in cands]
    assert tile in blocks[:4], (tile, blocks[:6])
    assert next(c for c in cands if c.default).block == tile


@pytest.mark.parametrize("strategy,depth,tile", [
    ("swc", 1, (2, 8, 32)), ("swc_stream", 1, (1, 8, 32)),
    ("tc", 1, (4, 8, 16)), ("swc", 2, (1, 4, 16)), ("tc", 2, (1, 8, 8)),
])
def test_model_ranks_the_hand_set_mhd_tiles_in_its_top_4(strategy, depth,
                                                         tile):
    """The MHD RHS at 256³ f32 (depth 1) and the RK3 pair (depth 2, the
    carry as aux), φ's arithmetic and thread limit counted."""
    solver = MHDSolver((256,) * 3, device=CPU)
    if depth == 1:
        phi, n_out, n_aux, flops = (mhd_rhs_device_phi(solver.params), 8,
                                    0, RHS_PHI_FLOPS)
    else:
        phi, n_out, n_aux, flops = (
            mhd_substep_device_phi(solver.params, 0.0, 1.0, 1e-3), 16, 8,
            SUBSTEP_PHI_FLOPS)
    cands = enumerate_candidates_nd(
        solver.operator_set, (256,) * 3, 8, n_out, strategies=(strategy,),
        fuse_steps_options=(depth,), n_aux=n_aux,
        n_slots=_slots_of(phi), max_threads=_max_threads_of(phi),
        operators=phi.operators, phi_flops=flops)
    blocks = [c.block for c in cands]
    assert tile in blocks[:4], (tile, blocks[:6])
