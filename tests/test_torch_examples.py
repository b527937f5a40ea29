"""The port's five examples (``examples/torch_*.py``), each the
counterpart of the reference's example of the same name, run in-process
through ``main([...])`` at tiny sizes with ``--device cpu`` (the
kernels' plain PyTorch versions; on the card ``chip_smoke.py`` phase 3
(examples) runs them through B1-B5 and B7). Each ends with its own
checks (the strategy cross-checks, the eigenvalue, the loss drop, the
one injected failure recovered) and prints its "OK" line. The tuner's
cache goes to a temporary directory."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

RUNS = {
    "torch_quickstart": [],
    "torch_mhd_simulation": ["--n", "8", "--steps", "3"],
    "torch_serve_ensemble": ["--requests", "6", "--steps", "2",
                             "--max-batch", "2"],
    "torch_serve_batched": ["--requests", "4", "--max-new", "6",
                            "--slots", "2"],
    "torch_train_lm": ["--steps", "60", "--global-batch", "4",
                       "--seq-len", "32", "--fail-at", "12"],
}


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune"))
    _example(name).main([*RUNS[name], "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith(
        name.removeprefix("torch_") + " OK"), out[-500:]


def test_examples_import_no_jax_and_no_reference_package():
    """Every import in the five examples, those inside functions too,
    names torch, numpy, the standard library or ``repro_torch``: never
    ``jax*`` or the JAX package ``repro``."""
    import ast

    for name in RUNS:
        tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        assert "repro_torch" in roots, name
        assert not roots & {"jax", "jaxlib", "repro"}, (name, roots)
