"""The port's serving loop (``repro_torch.launch.serve_sim``) and its
fault layer (``repro_torch.ft``) on the CPU: the port's ``SimServer``
against the JAX ``SimServer`` on the same seeded queue, and the
reference's serving and fault tests (``tests/test_serve_sim.py``,
``tests/test_faults.py``) run against the port.

Left out: the reference's tuning-cache test (``block="auto"``), the
``Supervisor`` tests and the chaos plan's tuning faults — the tuner and
the trainer are not ported yet (ROADMAP A9, A13). Tolerance: 1e-5
relative per request, the f32 workload's (the two packages round the
same taps' f32 arithmetic independently).
"""
import json
import time

import numpy as np
import pytest
import torch

from repro.launch import serve_sim as jserve
from repro_torch import ft
from repro_torch.ft.faults import (
    FaultInjector,
    FaultSpec,
    InjectedCompileFailure,
    InjectedResourceExhausted,
    chaos_specs,
)
from repro_torch.ft.supervisor import StragglerMonitor
from repro_torch.kernels import emit
from repro_torch.launch.serve_sim import (
    DEGRADATION_LADDER,
    RequestQueue,
    RetryPolicy,
    SimRequest,
    SimServer,
    check_parity,
    demo_queue,
    main,
    member_reference,
)

CPU = "cpu"


def _req(rid, shape=(8, 16), n_steps=2):
    f0 = torch.zeros((1,) + shape) + 1e-5 * (rid + 1)
    return SimRequest(rid, f0, n_steps)


def _server(**kw):
    kw.setdefault("strategy", "swc")
    kw.setdefault("max_batch", 4)
    kw.setdefault("retry", RetryPolicy(max_retries=2, backoff_s=0.0))
    kw.setdefault("device", CPU)
    return SimServer(**kw)


# --- the port against the JAX server --------------------------------------------


@pytest.mark.parametrize("strategy", ("swc", "swc_stream", "tc"))
def test_server_matches_jax_server_per_request(strategy):
    """``--smoke``'s queue (12 requests over (16, 32) and (12, 24), 8
    steps, batches of 4) through both servers: the same buckets, batch
    sizes and statuses, and each request's field at 1e-5."""
    shapes = [(16, 32), (12, 24)]
    jq = jserve.demo_queue(shapes, 8, 12)
    tq = demo_queue(shapes, 8, 12, device=CPU)
    for jr, tr in zip(jq.snapshot(), tq.snapshot()):
        assert np.array_equal(np.asarray(jr.f0), tr.f0.numpy())
        assert jr.bucket_key == tr.bucket_key
    jsrv = jserve.SimServer(strategy=strategy, max_batch=4)
    tsrv = SimServer(strategy=strategy, max_batch=4, device=CPU)
    want, got = jsrv.serve(jq), tsrv.serve(tq)
    assert sorted(got) == sorted(want) == list(range(12))
    for rid in want:
        w = np.asarray(want[rid], np.float64)
        g = got[rid].numpy().astype(np.float64)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    assert [(r.key, r.batch, r.strategy, r.statuses) for r in tsrv.reports] == [
        (r.key, r.batch, r.strategy, r.statuses) for r in jsrv.reports
    ]
    assert tsrv.op_builds == jsrv.op_builds == 2


def test_smoke_cli_on_cpu(capsys):
    main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 12/12 request(s) on cpu" in out
    assert "parity OK" in out and out.strip().endswith("serve_sim OK")


def test_check_parity_and_member_reference():
    queue = demo_queue([(12, 24)], n_steps=3, requests=3, seed=4, device=CPU)
    by_id = {r.req_id: r for r in queue.snapshot()}
    server = _server(max_batch=3)
    results = server.serve(queue)
    ref = member_reference(server, list(by_id.values()))
    assert ref.shape == (3, 1, 12, 24)
    assert check_parity(server, by_id, results) <= 1e-5 * float(ref.abs().max())
    results[1] = results[1] + 1.0
    with pytest.raises(AssertionError, match="parity failed"):
        check_parity(server, by_id, results)


# --- what waits for a ROADMAP item ----------------------------------------------


@pytest.mark.parametrize(
    "kw,item",
    [(dict(strategy="auto"), "A9"), (dict(block="auto"), "A9")],
)
def test_unported_options_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        SimServer(device=CPU, **kw)


@pytest.mark.parametrize("argv", (["--chaos"], ["--auto-tune"],
                                  ["--strategy", "auto"]))
def test_cli_options_of_the_tuner_raise(argv):
    with pytest.raises(NotImplementedError, match="A9"):
        main(argv + ["--device", "cpu"])


def test_ladder_skips_the_unported_tc_rung():
    """The reference skips a rung whose op does not build: ``swc_stream``
    at rank 1. The ``tc`` rung builds now (ROADMAP B4 is ported), so it
    is a rung like the others, at every rank."""
    server = _server()
    assert DEGRADATION_LADDER == ("tc", "swc_stream", "swc", "hwc")
    key2, key1 = ((8, 16), "float32", 2), ((32,), "float32", 2)
    assert server._next_viable("auto", key2) == "swc"
    server.retry = RetryPolicy(ladder=("swc", "tc", "swc_stream", "hwc"))
    assert server._next_viable("swc", key2) == "tc"
    assert server._next_viable("swc", key1) == "tc"
    assert server._next_viable("tc", key2) == "swc_stream"
    assert server._next_viable("tc", key1) == "hwc"


def test_tc_server_serves_every_bucket_on_tc():
    """``SimServer(strategy="tc")``, the ladder's top rung: every batch
    on ``tc``, every request ``ok``, within 1e-5 of its per-member plain
    version."""
    queue = demo_queue([(16, 32), (12, 24), (64,)], 4, 9, device=CPU)
    by_id = {r.req_id: r for r in queue.snapshot()}
    server = _server(strategy="tc")
    results = server.serve(queue)
    assert sorted(results) == list(range(9))
    assert {r.strategy for r in server.reports} == {"tc"}
    assert set(server.request_status.values()) == {"ok"}
    assert check_parity(server, by_id, results) >= 0.0


# --- tests/test_serve_sim.py, ported ----------------------------------------------


def test_mixed_queue_drains_into_correct_buckets():
    queue = RequestQueue()
    for rid in range(9):
        shape = (16, 32) if rid % 2 == 0 else (12, 24)
        queue.push(_req(rid, shape, n_steps=4 if rid < 6 else 8))
    batches = []
    while queue:
        key, reqs = queue.next_bucket(lambda r: r.bucket_key, max_batch=4)
        assert all(r.bucket_key == key for r in reqs)
        batches.append((key, [r.req_id for r in reqs]))
    assert [ids for _, ids in batches] == [
        [0, 2, 4], [1, 3, 5], [6, 8], [7]
    ]
    assert batches[0][0] == ((16, 32), "float32", 4)
    assert batches[2][0] == ((16, 32), "float32", 8)
    assert len({key for key, _ in batches}) == 4


def test_next_bucket_respects_max_batch_and_fifo():
    queue = RequestQueue([_req(i, (8, 16)) for i in range(5)])
    _, first = queue.next_bucket(lambda r: r.bucket_key, max_batch=4)
    assert [r.req_id for r in first] == [0, 1, 2, 3]
    _, rest = queue.next_bucket(lambda r: r.bucket_key, max_batch=4)
    assert [r.req_id for r in rest] == [4]
    assert not queue
    assert queue.next_bucket(lambda r: r.bucket_key, 4) is None
    assert queue.pop() is None


def test_server_routes_every_request_to_its_bucket_result():
    queue = demo_queue([(16, 32), (12, 24)], n_steps=4, requests=10,
                       device=CPU)
    expect_shape = {
        r.req_id: (1,) + r.bucket_key[0] for r in queue.snapshot()
    }
    server = _server(max_batch=4)
    emit.reset_launch_counts()
    results = server.serve(queue)
    assert sorted(results) == list(range(10))
    for rid, out in results.items():
        assert tuple(out.shape) == expect_shape[rid]
        assert out.device.type == "cpu"
    assert server.op_builds == 2
    assert {rep.key[0] for rep in server.reports} == {(16, 32), (12, 24)}
    assert emit.fused_stencil_swc.launches == 0  # CPU: the plain version


# A CPU batch of these shapes takes about a millisecond, where scheduler
# noise alone can exceed the monitor's 1.5x; every batch of the two
# straggler tests therefore also sleeps a uniform 20 ms, so only the
# injected stall stands out.
UNIFORM_S = 0.02


def test_straggler_monitor_flags_injected_slow_batch():
    slow_index = 6

    def inject(index, reqs):
        time.sleep(0.4 if index == slow_index else UNIFORM_S)

    server = _server(
        max_batch=2,
        straggler=StragglerMonitor(factor=1.5, window=20),
        batch_hook=inject,
    )
    queue = demo_queue([(16, 32)], n_steps=2, requests=14, device=CPU)
    results = server.serve(queue)
    assert len(results) == 14
    flags = [rep.straggler for rep in server.reports]
    assert flags[slow_index], server.reports
    assert not any(flags[:slow_index])
    assert server.straggler.flagged[0][0] == slow_index


def test_fast_batches_do_not_flag():
    server = _server(max_batch=2,
                     batch_hook=lambda index, reqs: time.sleep(UNIFORM_S))
    server.serve(demo_queue([(16, 32)], n_steps=2, requests=12, device=CPU))
    assert not any(rep.straggler for rep in server.reports)
    assert server.straggler.flagged == []


def test_server_matches_per_member_serving():
    queue = demo_queue([(12, 24)], n_steps=4, requests=4, seed=7, device=CPU)
    singles = {r.req_id: r for r in queue.snapshot()}
    batched = _server(max_batch=4).serve(queue)
    solo_server = _server(max_batch=1)
    for rid, req in singles.items():
        solo = solo_server.serve(RequestQueue([req]))[rid]
        torch.testing.assert_close(batched[rid], solo, rtol=0, atol=1e-6)


# --- tests/test_faults.py, ported --------------------------------------------------


def test_spec_validates_site_and_kind():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("serve.nonsense", "compile")
    with pytest.raises(ValueError, match="invalid for site"):
        FaultSpec("serve.batch", "nan")


def test_budget_transient_fires_once_persistent_forever():
    inj = FaultInjector([FaultSpec("serve.batch", "compile", times=1)])
    with pytest.raises(InjectedCompileFailure):
        inj.on_batch(0, [0], "swc")
    inj.on_batch(1, [0], "swc")
    assert len(inj.fired) == 1
    inj = FaultInjector([FaultSpec("serve.batch", "oom", times=0)])
    for index in range(3):
        with pytest.raises(InjectedResourceExhausted):
            inj.on_batch(index, [0], "swc")
    assert len(inj.fired) == 3


def test_selectors_are_conjunctive():
    inj = FaultInjector([
        FaultSpec("serve.batch", "compile", req_id=3, strategy="swc",
                  times=0),
    ])
    inj.on_batch(0, [1, 2], "swc")
    inj.on_batch(1, [3], "hwc")
    assert inj.fired == []
    with pytest.raises(InjectedCompileFailure):
        inj.on_batch(2, [2, 3], "swc")


def test_candidate_label_selector_substring_and_wildcard():
    inj = FaultInjector([
        FaultSpec("tune.candidate", "compile", label="8x16", times=0),
    ])
    inj.on_candidate("32x32")
    with pytest.raises(InjectedCompileFailure):
        inj.on_candidate("8x16@f2:s")
    inj = FaultInjector([
        FaultSpec("tune.candidate", "oom", label="*", times=1),
    ])
    with pytest.raises(InjectedResourceExhausted):
        inj.on_candidate("anything")


def test_chaos_specs_deterministic_targeted_and_equal_to_jax():
    from repro.ft import faults as jfaults

    ids = list(range(12))
    specs_a, plan_a = chaos_specs(7, ids)
    specs_b, plan_b = chaos_specs(7, ids)
    assert plan_a == plan_b
    assert [(s.site, s.kind, s.req_id) for s in specs_a] == [
        (s.site, s.kind, s.req_id) for s in specs_b
    ]
    assert plan_a["poison"] in ids and plan_a["transient"] in ids
    assert plan_a["poison"] != plan_a["transient"]
    _, plan_c = chaos_specs(8, ids)
    assert plan_c != plan_a
    # The copy derives the reference's plan from the same seed.
    jspecs, jplan = jfaults.chaos_specs(7, ids)
    assert jplan == plan_a
    assert [(s.site, s.kind, s.req_id, s.index, s.times) for s in jspecs] == [
        (s.site, s.kind, s.req_id, s.index, s.times) for s in specs_a
    ]
    with pytest.raises(ValueError, match="at least one"):
        chaos_specs(0, [])


def test_corrupt_cache_garbage_and_truncate(tmp_path):
    target = tmp_path / "cache.json"
    target.write_text('{"records": {}}')
    inj = FaultInjector([FaultSpec("cache.file", "truncate", times=1)])
    assert inj.corrupt_cache(target)
    assert len(target.read_bytes()) < len('{"records": {}}')
    inj = FaultInjector([FaultSpec("cache.file", "garbage", times=1)])
    assert inj.corrupt_cache(target)
    with pytest.raises(ValueError):
        json.loads(target.read_text())
    before = target.read_bytes()
    assert not inj.corrupt_cache(target)
    assert target.read_bytes() == before


def test_transient_batch_failure_retries_to_completion():
    inj = FaultInjector([
        FaultSpec("serve.batch", "compile", req_id=0, times=1),
    ])
    server = _server(faults=inj)
    results = server.serve(RequestQueue([_req(0), _req(1)]))
    assert sorted(results) == [0, 1]
    assert server.error_reports == {}
    [rep] = server.reports
    assert rep.retries == 1
    assert rep.strategy == "swc"
    assert rep.statuses == {0: "retried", 1: "retried"}
    assert server.request_status == {0: "retried", 1: "retried"}


def test_strategy_failure_degrades_down_the_ladder():
    inj = FaultInjector([
        FaultSpec("serve.batch", "oom", strategy="swc", times=0),
    ])
    server = _server(faults=inj, max_batch=2)
    results = server.serve(RequestQueue([_req(i) for i in range(4)]))
    assert sorted(results) == [0, 1, 2, 3]
    assert server.error_reports == {}
    assert [rep.strategy for rep in server.reports] == ["hwc", "hwc"]
    assert server.reports[0].statuses == {0: "degraded", 1: "degraded"}
    assert len(inj.fired) == 3
    assert server._strategy_for


@pytest.mark.parametrize("strategy", ("swc", "swc_stream"))
def test_card_ladder_never_degrades_to_the_plain_version(
    monkeypatch, strategy
):
    """On a CUDA device the ladder stops above ``hwc``: a batch whose
    kernel keeps failing is bisected and quarantined, never served by
    the plain version. The device is only named ``cuda`` here; the
    failing kernel and the op builds are stand-ins, so the ladder logic
    runs on the CPU."""
    server = _server(strategy=strategy, max_batch=4)
    server.device = torch.device("cuda")
    monkeypatch.setattr(server, "_op_for", lambda key, strategy: None)

    def kernel_fails(key, reqs, strategy):
        raise RuntimeError(f"kernel of {strategy} did not launch")

    monkeypatch.setattr(server, "_run_batch", kernel_fails)
    key = ((8, 16), "float32", 2)
    assert server._next_viable("swc", key) is None
    assert server._next_viable("swc_stream", key) == "swc"
    results = server.serve(RequestQueue([_req(i) for i in range(4)]))
    assert results == {}
    assert set(server.error_reports) == {0, 1, 2, 3}
    assert set(server.request_status.values()) == {"quarantined"}
    assert "hwc" not in {rep.strategy for rep in server.reports}
    assert {rep.strategy for rep in server.reports} == {"swc"}


def test_poison_request_is_bisected_and_quarantined():
    inj = FaultInjector([
        FaultSpec("serve.batch", "compile", req_id=2, times=0),
    ])
    server = _server(faults=inj)
    results = server.serve(RequestQueue([_req(i) for i in range(4)]))
    assert sorted(results) == [0, 1, 3]
    assert set(server.error_reports) == {2}
    assert "InjectedCompileFailure" in server.error_reports[2]["error"]
    assert server.error_reports[2]["bucket"] == "8x16/float32/n2"
    assert server.request_status[2] == "quarantined"
    assert server.request_status[0] != "quarantined"
    assert server.request_status[3] != "quarantined"
    assert server._strategy_for == {}
    quarantine_reports = [
        rep for rep in server.reports
        if rep.statuses.get(2) == "quarantined"
    ]
    assert len(quarantine_reports) == 1
    assert quarantine_reports[0].batch == 1


def test_nan_output_quarantines_only_the_poisoned_member():
    inj = FaultInjector([
        FaultSpec("serve.output", "nan", req_id=1, times=0),
    ])
    server = _server(faults=inj)
    results = server.serve(RequestQueue([_req(i) for i in range(3)]))
    assert sorted(results) == [0, 2]
    assert set(server.error_reports) == {1}
    assert "non-finite" in server.error_reports[1]["error"]
    [rep] = server.reports
    assert rep.statuses == {0: "ok", 1: "quarantined", 2: "ok"}
    for rid in (0, 2):
        assert bool(torch.isfinite(results[rid]).all())


def test_corrupt_output_poisons_a_clone_on_the_stack_device():
    out = torch.zeros(3, 1, 4)
    inj = FaultInjector([FaultSpec("serve.output", "inf", req_id=7)])
    got = inj.corrupt_output([5, 7, 9], out)
    assert got is not out and not out.any()
    assert torch.isinf(got[1]).all() and not got[0].any() and not got[2].any()
    assert inj.corrupt_output([5, 7, 9], out) is out  # budget spent


def test_validate_output_can_be_disabled():
    inj = FaultInjector([
        FaultSpec("serve.output", "inf", req_id=0, times=0),
    ])
    server = _server(faults=inj, validate_output=False)
    results = server.serve(RequestQueue([_req(0)]))
    assert bool(torch.isinf(results[0]).all())
    assert server.error_reports == {}


def test_slow_fault_stalls_without_failing():
    inj = FaultInjector(
        [FaultSpec("serve.batch", "slow", index=0, times=1)], slow_s=0.05,
    )
    server = _server(faults=inj)
    results = server.serve(RequestQueue([_req(0)]))
    assert sorted(results) == [0]
    assert inj.fired == [
        ("serve.batch", "slow", "index=0 reqs=[0] strategy=swc")
    ]
    assert server.reports[0].seconds >= 0.05


def test_retry_policy_ladder_and_auto_reentry():
    policy = RetryPolicy()
    assert policy.degrade("tc") == "swc_stream"
    assert policy.degrade("swc_stream") == "swc"
    assert policy.degrade("swc") == "hwc"
    assert policy.degrade("hwc") is None
    assert policy.degrade("auto") == "swc"
    assert policy.degrade("mystery") is None
    assert policy.backoff(1) == policy.backoff_s
    assert policy.backoff(2) == 2 * policy.backoff_s


def test_package_exports_the_fault_layer():
    assert ft.FaultInjector is FaultInjector
    assert ft.StragglerMonitor is StragglerMonitor
    assert issubclass(ft.InjectedCompileFailure, ft.InjectedFault)


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ("swc", "swc_stream", "tc"))
def test_server_on_card_launches_once_per_step(cuda_device, strategy):
    queue = demo_queue([(16, 32), (12, 24)], n_steps=3, requests=8,
                       device=cuda_device)
    by_id = {r.req_id: r for r in queue.snapshot()}
    server = SimServer(strategy=strategy, max_batch=4)
    emit.reset_launch_counts()
    results = server.serve(queue)
    assert [r.strategy for r in server.reports] == [strategy] * 2
    assert set(server.request_status.values()) == {"ok"}
    assert emit.fused_stencil_swc.launches == 2 * 3  # 2 batches x 3 steps
    assert check_parity(server, by_id, results) >= 0.0


@pytest.mark.cuda
def test_server_on_card_quarantines_when_the_kernel_does_not_build(
    cuda_device, monkeypatch
):
    """A kernel that fails to build surfaces as quarantined requests,
    never as a batch served by the plain ``hwc`` rung."""
    def build_fails(name):
        raise RuntimeError(f"nvcc failed on {name}.cu")

    monkeypatch.setattr(emit, "_lib", build_fails)
    server = SimServer(strategy="swc_stream", max_batch=4,
                       retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    queue = demo_queue([(16, 32)], n_steps=2, requests=4,
                       device=cuda_device)
    results = server.serve(queue)
    assert results == {}
    assert set(server.request_status.values()) == {"quarantined"}
    assert "hwc" not in {rep.strategy for rep in server.reports}


@pytest.mark.cuda
def test_tc_bucket_degrades_to_swc_stream_when_tc_does_not_build(
    cuda_device, monkeypatch
):
    """The tc kernel's build made to fail: the bucket degrades to
    ``swc_stream`` on the card (every request ``degraded``, served by the
    stream kernel), never to ``hwc``."""
    real = emit._lib

    def tc_build_fails(name):
        if name == emit.TC_KERNEL:
            raise RuntimeError(f"nvcc failed on {name}.cu")
        return real(name)

    monkeypatch.setattr(emit, "_lib", tc_build_fails)
    server = SimServer(strategy="tc", max_batch=4,
                       retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    queue = demo_queue([(16, 32)], n_steps=2, requests=4,
                       device=cuda_device)
    by_id = {r.req_id: r for r in queue.snapshot()}
    emit.reset_launch_counts()
    results = server.serve(queue)
    assert sorted(results) == [0, 1, 2, 3]
    assert set(server.request_status.values()) == {"degraded"}
    assert {rep.strategy for rep in server.reports} == {"swc_stream"}
    assert set(emit.fused_stencil_swc.launches_by_kernel) == {
        emit.STREAM_KERNEL
    }
    assert check_parity(server, by_id, results) >= 0.0
