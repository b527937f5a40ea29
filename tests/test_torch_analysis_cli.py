"""The static auditor's command line, and its tie to the CUDA bodies.

On the CPU: ``python -m repro_torch.analysis --smoke`` (the registry and
the tuner's whole candidate spaces at the smoke extents) and
``--mutants`` exit 0 in a subprocess, the smoke report is finding-free,
names every body and counts what is not ported under its ROADMAP item.

On the card (marker ``cuda``; they skip here): for one plan of each body,
the library's ``repro_<name>_layout`` fields and shared bytes equal the
auditor's field by field, and a guard-band launch (the input a view one
element past 16 bytes inside NaN, the output's interior NaN) leaves the
guards' NaN bits alone, writes every output and equals the launch on
ordinary tensors bit for bit. The file imports nothing of JAX, so its
``cuda`` tests run on the card's machine.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import audit_launch, audit_plan
from repro_torch.analysis.bodies import Conv1dLaunch, XcorrLaunch
from repro_torch.core import stencil as ts
from repro_torch.kernels import conv1d_depthwise as kc
from repro_torch.kernels import emit, ref
from repro_torch.kernels import xcorr1d as kx
from repro_torch.kernels.ops import plan_for_nd
from repro_torch.kernels.phi import select_phi

SRC = str(Path(__file__).resolve().parents[1] / "src")
BODIES = {"swc_body", "stream_body", "stream_buffer", "temporal_walk_body",
          "tc_walk_body", "tc_body", "temporal_body", "xcorr1d",
          "conv1d_depthwise"}


def _cli(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True, env=env,
                          timeout=600)


@pytest.fixture(scope="module")
def smoke_report(tmp_path_factory):
    path = tmp_path_factory.mktemp("audit") / "audit.json"
    proc = _cli("--smoke", "--json", str(path))
    return proc, json.loads(path.read_text())


def test_smoke_cli_exits_0_finding_free(smoke_report):
    proc, report = smoke_report
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert report["findings"] == [] and report["counts"]["findings"] == 0
    assert "findings 0" in proc.stdout


def test_smoke_audits_every_body_and_the_candidates(smoke_report):
    _, report = smoke_report
    assert set(report["bodies"]) == BODIES
    assert all(n >= 1 for n in report["bodies"].values())
    c = report["counts"]
    assert c["registry"] > 200 and c["candidates"] > 1000
    assert c["sid_combos"] == 1470 and c["unaudited"] == 0
    assert set(report["not_ported"]) <= {"B9"}


def test_mutants_cli_catches_all_eleven():
    proc = _cli("--mutants")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all 11 mutants detected" in proc.stdout
    assert "MISSED" not in proc.stdout


def test_out_tensors_are_checked_on_the_cpu():
    """The wrappers' ``out``: the plain version's result lands in it; a
    wrong shape, dtype or a non-contiguous view raises."""
    ops = ts.derivative_operator_set(2, 2)
    f = torch.rand(1, 12, 20, dtype=torch.float64)
    plan = plan_for_nd(ops, tuple(f.shape), 1, dtype="float64")
    out = torch.empty(1, 10, 18, dtype=torch.float64)
    got = emit.fused_stencil_swc(f, ops, select_phi("dxx"), plan, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, emit.fused_stencil_swc(f, ops, select_phi("dxx"),
                                                   plan))
    for bad in (torch.empty(1, 10, 17, dtype=torch.float64),
                torch.empty(1, 10, 18, dtype=torch.float32),
                torch.empty(1, 18, 10, dtype=torch.float64).transpose(1, 2)):
        with pytest.raises(ValueError):
            emit.fused_stencil_swc(f, ops, select_phi("dxx"), plan, out=bad)
    g = torch.rand(5, dtype=torch.float64)
    y = torch.empty(96, dtype=torch.float64)
    assert kx.xcorr1d_cuda(torch.rand(100, dtype=torch.float64), g,
                           out=y) is y
    x = torch.rand(2, 9, 4)
    z = torch.empty(2, 9, 4)
    assert kc.conv1d_depthwise_cuda(x, torch.rand(3, 4), out=z) is z


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _plans():
    """One plan of each fused body: (label, shape, kw, body)."""
    return (
        ((16, 20, 40), dict(block=(4, 5, 20)), "swc_body"),
        ((64, 128), dict(strategy="swc_stream"), "stream_body"),
        ((48, 64), dict(fuse_steps=3), "temporal_walk_body"),
        ((4096,), dict(fuse_steps=2), "temporal_body"),
        ((8, 16, 32), dict(strategy="tc"), "tc_body"),
        ((16, 16, 32), dict(strategy="tc", fuse_steps=2), "tc_walk_body"),
    )


def _nan_view(shape, dtype, device, offset):
    g = 4096 // torch.empty((), dtype=dtype).element_size()
    n = 1
    for s in shape:
        n *= s
    flat = torch.full((2 * g + offset + n,), float("nan"), dtype=dtype,
                      device=device)
    return flat, flat[g + offset:g + offset + n].view(shape)


def _intact(flat, view) -> bool:
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        flat.element_size()]
    bits = flat.view(ints)
    lo = (view.data_ptr() - flat.data_ptr()) // flat.element_size()
    hi = lo + view.numel()
    return bool((bits[:lo] == bits[0]).all() and (bits[hi:] == bits[0]).all())


def _guarded(launch, x, device):
    """launch(x, out) on views inside NaN: (ordinary, guarded, guards ok)."""
    want = launch(x, None)
    fx, vx = _nan_view(tuple(x.shape), x.dtype, device, 1)
    vx.copy_(x)
    fo, vo = _nan_view(tuple(want.shape), want.dtype, device, 0)
    launch(vx, vo)
    torch.cuda.synchronize()
    return want, vo, _intact(fo, vo) and _intact(fx, vx)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw,body", _plans())
def test_layout_and_guard_band_on_card(cuda_device, shape, kw, body):
    ops = ts.derivative_operator_set(len(shape), 6)
    fuse = kw.get("fuse_steps", 1)
    padded = (1,) + tuple(n + 6 * fuse for n in shape)
    plan = plan_for_nd(ops, padded, 1, **kw)
    res = audit_plan(plan, ops)
    assert res.findings == [] and res.body == body
    lib_body, fields = emit.layout_fields(plan)
    assert (lib_body, fields) == (res.body, res.layout)
    assert emit.kernel_smem_bytes(plan) == res.measured_smem
    gen = torch.Generator(device="cpu").manual_seed(0)
    f = torch.rand(padded, generator=gen).to(cuda_device)
    phi = select_phi("dxx")

    def launch(x, out):
        return emit.fused_stencil_swc(x, ops, phi, plan, out=out)

    want, got, ok = _guarded(launch, f, cuda_device)
    assert ok and not bool(torch.isnan(got).any())
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_one_buffer_stream_layout_and_guard_band_on_card(cuda_device):
    from repro_torch.core.boundary import pad
    from repro_torch.physics import mhd

    solver = mhd.MHDSolver((8, 8, 32), strategy="swc", device=cuda_device)
    f = solver.init_smooth(0, amplitude=1e-2, dtype="float64")
    fp = pad(f, 3, "periodic", spatial_axes=(1, 2, 3))
    phi = mhd.mhd_rhs_device_phi(solver.params)
    plan = plan_for_nd(solver.operator_set, tuple(fp.shape), 8,
                       strategy="swc_stream", block=solver.block,
                       dtype="float64", max_threads=256, n_slots=10)
    res = audit_plan(plan, solver.operator_set)
    assert res.findings == [] and res.body == "stream_buffer"
    assert emit.layout_fields(plan) == (res.body, res.layout)

    def launch(x, out):
        return emit.fused_stencil_swc(x, solver.operator_set, phi, plan,
                                      out=out)

    want, got, ok = _guarded(launch, fp, cuda_device)
    assert ok and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,unroll,radius", (
    ("baseline", 4, 1), ("elementwise", 8, 64)))
def test_xcorr_layout_and_guard_band_on_card(cuda_device, strategy, unroll,
                                             radius):
    n = 5000 + 123
    gen = torch.Generator(device="cpu").manual_seed(0)
    f = torch.randn(n + 2 * radius, generator=gen).to(cuda_device)
    g = torch.randn(2 * radius + 1, generator=gen).to(cuda_device)
    lc = XcorrLaunch(n, 2 * radius + 1, 1024, strategy, unroll, "float32")
    res = audit_launch(lc)
    assert res.findings == []
    assert kx.layout_fields(lc.n_taps, 1024, strategy, unroll,
                            "float32") == (res.body, res.layout)

    def launch(x, out):
        return kx.xcorr1d_cuda(x, g, strategy=strategy, block_size=1024,
                               unroll=unroll, out=out)

    want, got, ok = _guarded(launch, f, cuda_device)
    assert ok and torch.equal(got, want)
    assert torch.allclose(want, ref.xcorr1d(f, g), rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_conv1d_layout_and_guard_band_on_card(cuda_device):
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(2, 257, 32, generator=gen).to(cuda_device)
    w = torch.randn(4, 32, generator=gen).to(cuda_device)
    res = audit_launch(Conv1dLaunch(2, 257, 32, 4, "float32", 4))
    assert res.findings == []
    assert kc.layout_fields(2, 257, 32, 4) == (res.body, res.layout)

    def launch(v, out):
        return kc.conv1d_depthwise_cuda(v, w, out=out)

    want, got, ok = _guarded(launch, x, cuda_device)
    assert ok and torch.equal(got, want)
