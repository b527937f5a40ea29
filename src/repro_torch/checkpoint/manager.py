"""Checkpoint manager: async, atomic, keep-k (port of
``repro.checkpoint.manager``, a copy: the port imports nothing of
``repro``). The layout is the reference's, so either package restores
what the other wrote::

    <dir>/step_00000120.tmp-<nonce>/   (written)
    <dir>/step_00000120/               (atomic rename on completion)
        manifest.json                  (step, per-leaf path, file, shape,
                                        dtype, and the tree's repr)
        <leaf-path>.npy                (one file per leaf, the path's
                                        characters outside [A-Za-z0-9_.-]
                                        as "_")

A leaf's path is its keys joined by "/" as the reference spells them
(``repro_torch.tree``): ``params/blocks/in_proj``, ``opt/mu/embed``,
``opt/step``.

* **atomicity** — a checkpoint is visible iff complete (tmp-dir + rename;
  a crashed save never corrupts the latest-step discovery);
* **async**     — device→host copies happen at once, in ``save``; the
  file I/O on a background thread so the train loop isn't blocked;
* **keep-k**    — bounded disk usage with the newest k checkpoints;
* **restore**   — each leaf lands on its target leaf's device, in the
  dtype it was saved in;
* **elastic**   — leaves are stored whole. ``save(..., shardings=)``
  from a sharded state (``distrib.sharding.NamedSharding`` leaves, a
  collective: every rank calls it) gathers each leaf to its full shape;
  rank 0 writes and the others wait at a barrier until the step is on
  disk. ``restore(..., shardings=)`` cuts each stored leaf to this
  rank's block under the shardings of the mesh it runs on now, so a
  checkpoint taken on one mesh continues on another.

Leaves are float32, float64, integer or bool tensors: numpy has no
bfloat16, so a bfloat16 leaf raises at ``save`` (the trainer keeps
float32 master weights).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import uuid
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import (
    path_str,
    tree_leaves_with_path,
    tree_map,
    tree_map_with_path,
)

_STEP_RE = re.compile(r"^step_(\d+)$")


def _sanitize(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path)


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A copy of ``leaf`` in host memory (a CPU tensor's own storage is
    not shared: the caller may overwrite it right after ``save``)."""
    if leaf.dtype == torch.bfloat16:
        raise TypeError(
            "bfloat16 leaves cannot be checkpointed (numpy has no "
            "bfloat16); keep float32 master weights"
        )
    return leaf.detach().to("cpu", copy=True).numpy()


def _structure(tree) -> str:
    """The tree with each leaf as ``*`` (the manifest's ``treedef``)."""
    return repr(tree_map(lambda _: "*", tree))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = False,
             shardings: Any = None) -> None:
        """Snapshot to host memory now; write to disk (a)synchronously.
        With ``shardings`` (the tree's, of a sharded run) every leaf is
        gathered whole, rank 0 writes it and every rank returns once the
        step is on disk."""
        if shardings is not None:
            self._save_sharded(step, tree, shardings)
            return
        host_leaves = [(path_str(path), _to_host(leaf))
                       for path, leaf in tree_leaves_with_path(tree)]
        self.wait()  # one in-flight save at a time
        worker = threading.Thread(
            target=self._write, args=(step, host_leaves, _structure(tree)),
            daemon=True,
        )
        worker.start()
        self._thread = worker
        if blocking:
            self.wait()

    def _save_sharded(self, step: int, tree: Any, shardings: Any) -> None:
        by_path = dict(tree_leaves_with_path(shardings))
        writer = dist.get_rank() == 0
        host_leaves = []
        for path, leaf in tree_leaves_with_path(tree):
            sh = by_path[path]
            full = leaf if sh.replicated else sh.gather(leaf)
            if writer:
                host_leaves.append((path_str(path), _to_host(full)))
            del full
        if writer:
            self.wait()
            self._write(step, host_leaves, _structure(tree))
        dist.barrier()

    def _write(self, step: int, host_leaves, treedef_repr: str) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": [], "treedef": treedef_repr}
        for path, arr in host_leaves:
            fname = _sanitize(path) + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {
                    "path": path,
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                }
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(
                os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True
            )

    # -- restore ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(
                os.path.join(self.dir, name, "manifest.json")
            ):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree: Any, step: int | None = None, *,
                shardings: Any = None) -> tuple[Any, int]:
        """Load into the structure of ``target_tree`` (the latest step
        when ``step`` is None) → (tree, step). Each leaf comes back as a
        tensor on its target leaf's device, in the dtype it was saved
        in; a missing leaf or another shape raises. With ``shardings``
        (``target_tree``'s, on this run's mesh) each stored full leaf is
        cut to this rank's block first: the elastic path."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        sh_by_path = (dict(tree_leaves_with_path(shardings))
                      if shardings is not None else {})

        def load(path, ref_leaf):
            name = path_str(path)
            entry = by_path.get(name)
            if entry is None:
                raise KeyError(f"checkpoint step {step} missing leaf {name}")
            t = torch.from_numpy(np.load(os.path.join(d, entry["file"])))
            if path in sh_by_path:
                t = sh_by_path[path].shard(t).contiguous()
            if tuple(t.shape) != tuple(ref_leaf.shape):
                raise ValueError(
                    f"shape mismatch for {name}: ckpt {tuple(t.shape)} "
                    f"vs model {tuple(ref_leaf.shape)}"
                )
            return t.to(ref_leaf.device)

        return tree_map_with_path(load, target_tree), step
