#!/usr/bin/env python3
"""Compare two trees' builds of one kernel source, function by function:
ptxas's registers and spills, and the SASS (``cuobjdump -sass``) with
addresses and encodings stripped.

    python3 tools/sass_diff.py PARENT_DIR CHANGE_DIR conv1d_depthwise \\
        conv1d_depthwise_kernelI13__nv_bfloat16Li8ELi4ELi0E ...

Each KEY is a piece of a mangled kernel name; the first function of each
tree's library whose name holds it is compared. Both trees must have
built the source already (``python3 chip_smoke.py``, or any call of the
kernel), each into its own ``build/repro_torch/``. Prints, per key, each
tree's registers and spill bytes and whether the instruction lists are
equal (else how many lines differ and their counts). Needs the CUDA
toolkit's ``cuobjdump`` (on PATH or under /usr/local/cuda/bin); no card.
"""
from __future__ import annotations

import difflib
import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
ENCODING = re.compile(r"^\s*/\* 0x[0-9a-f]+ \*/\s*$")


def _build_module(tree: Path):
    """The tree's ``repro_torch/kernels/build.py``, loaded on its own."""
    path = tree / "src" / "repro_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(f"build_{id(tree)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or "/usr/local/cuda/bin/cuobjdump"


def functions(lib: Path) -> dict[str, list[str]]:
    """{mangled name: its SASS lines, addresses and encodings stripped}."""
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None and line.strip() and not ENCODING.match(line):
            body = ADDR.sub("", line).split(";")[0].strip()
            if body and not body.startswith("."):
                out[name].append(body)
    return out


def usage(build, source: str) -> dict[str, tuple[int, int]]:
    """{entry: (registers, spill store bytes)} from the tree's ptxas log."""
    path = build.library_path(source).with_suffix(".ptxas.txt")
    res: dict[str, tuple[int, int]] = {}
    entry, spill = None, 0
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            spill = 0
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and entry:
            res[entry] = (int(line.split("Used")[1].split()[0]), spill)
            entry = None
    return res


def _regs(use) -> str:
    return "? registers" if use is None else (
        f"{use[0]} registers {use[1]} B spilled")


def main(argv: list[str]) -> int:
    if len(argv) < 4:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [Path(a).resolve() for a in argv[:2]]
    source, keys = argv[2], argv[3:]
    found = []
    for tree in trees:
        build = _build_module(tree)
        found.append((functions(build.library_path(source)),
                      usage(build, source)))
    for key in keys:
        picked = []
        for fns, use in found:
            name = next((n for n in fns if key in n), None)
            regs = next((v for n, v in use.items() if key in n), None)
            picked.append((name, fns.get(name, []), regs))
        (na, a, ra), (nb, b, rb) = picked
        if na is None or nb is None:
            print(f"{key}: not in {'parent' if na is None else 'change'}")
            continue
        diff = [d for d in difflib.unified_diff(a, b, lineterm="", n=0)
                if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        same = "SASS equal" if not diff else (
            f"SASS differs: {len(diff)} lines (-/+), {len(a)} vs {len(b)} "
            "instructions")
        print(f"{key}: parent {_regs(ra)}, change {_regs(rb)}; {same}")
        for d in diff[:12]:
            print(f"    {d}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
