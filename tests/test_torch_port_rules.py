"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX
package, its entry points run on the card unless the caller asks for
the CPU, ``swc`` never takes a φ it cannot compile, and
``chip_smoke.py`` prints no result without a card or without the repo."""
import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.core.fusion import FusedStencilOp
from repro_torch.core.stencil import derivative_operator_set
from repro_torch.physics.diffusion import DiffusionProblem, simulate
from repro_torch.physics.mhd import MHDSolver

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PKG = SRC / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_no_jax_and_no_reference_package():
    """Import every module of the port and run a CPU step of each
    solver (diffusion on ``swc`` and on ``tc`` in f32 and bf16, MHD on
    ``swc`` and ``tc``) and of the reduced mamba2 (a prefill, a decode
    step, the serve loop) in a fresh interpreter; then neither ``jax*``
    nor ``repro``/``repro.*`` may be loaded."""
    modules = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts)
        for p in PKG.rglob("*.py")
    )
    code = textwrap.dedent(f"""
        import importlib, json, sys
        for m in {modules!r}:
            importlib.import_module(m.removesuffix(".__init__"))
        from repro_torch.physics.diffusion import DiffusionProblem, simulate
        from repro_torch.physics.mhd import MHDSolver
        p = DiffusionProblem((8, 16))
        simulate(p, p.init_field(device="cpu"), 2, strategy="swc", device="cpu")
        for dtype in ("float32", "bfloat16"):
            simulate(p, p.init_field(device="cpu", dtype=dtype), 2,
                     strategy="tc", fuse_steps=2, device="cpu")
        s = MHDSolver((8, 8, 16), strategy="swc", fuse_rk_axpy=True, device="cpu")
        s.step(s.init_fields(), 1e-3)
        s = MHDSolver((8, 8, 16), strategy="tc", fuse_rk_pairs=True, device="cpu")
        s.step(s.init_fields(), 1e-3)
        import torch
        from repro_torch.configs.registry import get_config, reduced_config
        from repro_torch.launch.serve import serve
        from repro_torch.launch.steps import make_prefill_step, make_serve_step
        from repro_torch.models import ssm
        cfg = reduced_config(get_config("mamba2-780m"))
        prm = ssm.init_params(cfg, device="cpu")
        tok = torch.zeros((1, 16), dtype=torch.long)
        make_prefill_step(cfg, device="cpu")(prm, {{"tokens": tok}})
        make_serve_step(cfg, device="cpu")(
            prm, ssm.init_decode_cache(cfg, 1, 16, device="cpu"),
            {{"tokens": tok[:, :1]}})
        serve(cfg, batch=1, steps=2, device="cpu", params=prm)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print(json.dumps(bad))
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=_env(), timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_no_jax_or_reference_import():
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.kernels.phi import select_phi
    from repro_torch.verify import manufactured_solution, run_convergence

    p = DiffusionProblem((8,))
    ops = derivative_operator_set(1, 2)
    calls = (
        lambda: FusedStencilOp(ops, select_phi("val"), 1, strategy="swc"),
        lambda: MHDSolver((4, 4, 4)),
        lambda: MHDSolver((4, 4, 4), device="cuda"),
        lambda: p.init_field(),
        lambda: p.fourier_mode((1,)),
        lambda: p.step_op("swc"),
        lambda: simulate(p, torch.zeros(1, 8), 1),
        lambda: manufactured_solution(1, "periodic", 12),
        lambda: manufactured_solution(1, "periodic", 12, device="cuda"),
        lambda: run_convergence(1, 2),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # ...and run when the caller asks for the CPU.
    assert simulate(p, p.init_field(device="cpu"), 1, device="cpu").shape == (1, 8)


def test_server_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.launch.serve_sim import SimServer, demo_queue

    for call in (
        lambda: SimServer(),
        lambda: SimServer(device="cuda"),
        lambda: demo_queue([(8, 16)], 1, 1),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert SimServer(device="cpu").device == torch.device("cpu")


def test_mamba2_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.launch.serve import main, serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import ssm

    cfg = reduced_config(get_config("mamba2-780m"))
    for call in (
        lambda: ssm.init_params(cfg),
        lambda: ssm.init_params(cfg, device="cuda"),
        lambda: ssm.init_decode_cache(cfg, 1, 8),
        lambda: make_prefill_step(cfg),
        lambda: make_serve_step(cfg),
        lambda: serve(cfg, batch=1, steps=1),
        lambda: main(["--reduced", "--steps", "1"]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # ...a step refuses tokens that are not on its device...
    prm = ssm.init_params(cfg, device="cpu")
    step = make_prefill_step(cfg, device="meta")
    with pytest.raises(ValueError, match="this step runs on meta"):
        step(prm, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    # ...and the CPU runs when asked for.
    assert make_prefill_step(cfg, device="cpu")(
        prm, {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    ).shape == (1, cfg.vocab)


def test_swc_refuses_a_bare_callable():
    ops = derivative_operator_set(1, 2)
    with pytest.raises(ValueError, match="strategy='hwc'"):
        FusedStencilOp(ops, lambda d: d["val"], 1, strategy="swc")
    FusedStencilOp(ops, lambda d: d["val"], 1, strategy="hwc",
                   device="cpu")  # fine there


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(strategy="swc", block="auto", fuse_steps="auto"), "A9"),
        (dict(strategy="auto"), "A9"),
        (dict(strategy="swc", block="auto"), "A9"),
    ],
)
def test_fused_op_names_the_roadmap_item_it_lacks(kw, item, tmp_path,
                                                 monkeypatch):
    """The tuner's options (ROADMAP ``item``, ported) resolve on the CPU
    by the model alone, into records under the ``cpu`` backend, and the
    op equals the explicit launch of the strategy and depth they
    resolved to."""
    from repro_torch.kernels.phi import select_phi
    from repro_torch.tuning import TuningCache, session

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path))
    ops = derivative_operator_set(2, 2)
    f = torch.randn(1, 16, 32, generator=torch.Generator().manual_seed(0))
    op = FusedStencilOp(ops, select_phi("val"), 1, device="cpu", **kw)
    before = session.MEASURE_COUNT
    rop = op.resolved(f)
    assert not rop.needs_resolution
    explicit = FusedStencilOp(ops, select_phi("val"), 1,
                              strategy=rop.strategy,
                              fuse_steps=rop.fuse_steps, device="cpu")
    assert torch.equal(op(f), explicit(f))
    records = TuningCache().items()
    assert records and session.MEASURE_COUNT == before
    assert all(r.source == "model" and k.endswith("|cpu")
               for k, r in records.items())


def test_chip_smoke_prints_no_result_without_card_or_repo(tmp_path):
    # Alone in a directory it cannot find the port, card or no card.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs = [tmp_path]
    if not torch.cuda.is_available():
        runs.append(ROOT)  # the full repo, but no card
    for cwd in runs:
        out = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
            text=True, timeout=120, env={**os.environ, "PYTHONPATH": ""},
        )
        assert out.returncode != 0, cwd
        assert '"ok"' not in out.stdout
