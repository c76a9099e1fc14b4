"""Checkpointing: step-atomic, self-describing, async-capable, resumable.

The port's counterpart of ``repro.train.checkpoint``, with the reference's
on-disk layout, so that a directory written by either package restores in
the other as a tree of arrays:

    <dir>/step_000000100/
        manifest.json        tree structure, dtypes, shapes, step, extra
        arrays/<idx>.npy     one file per leaf (np.save)
    <dir>/step_000000100.COMMIT  written LAST → a checkpoint without COMMIT
                                 is torn (crashed mid-write) and ignored

A tree is nested dicts / lists / tuples of tensors (or numpy arrays).
``save`` writes each leaf as numpy on the host; a bfloat16 leaf is stored as
its uint16 bits with ``"bfloat16"`` in the manifest, which is how
``models.convert`` reads bfloat16. ``restore`` places the leaves on an
explicit ``device`` (default: the card) as tensors, or, given
``shardings=`` (a tree of ``sharding.partition.NamedSharding``), each leaf
by its sharding as a DTensor: every rank reads the same file and keeps its
own slice, so nothing is scattered, and a checkpoint written on one mesh
restores onto any other (elastic re-meshing).

DTensor leaves (``train(..., mesh=)``): every rank of the mesh calls
``save`` with the same tree; each leaf is gathered (``full_tensor()``) in
the calling thread, in the same order on every rank; only the mesh's rank 0
writes and commits, and every rank then waits on a barrier, so no rank goes
on before the COMMIT marker is written. The layout on disk is the same.

Fault-tolerance contract (``train.fault_tolerance`` builds on this): writes
go to a temp dir, then ``os.replace`` (atomic on POSIX); ``latest_step``
scans COMMIT markers only; ``restore`` validates the manifest against a
target tree.

``AsyncCheckpointer`` overlaps serialization with the next train steps (one
write in flight; ``save`` joins the previous one). Its ``save`` copies every
tensor to host memory before it returns: the port's optimizer updates
parameters in place, so a copy deferred to the writer thread, or issued
``non_blocking`` without a sync, would save a half-updated step. With
DTensor leaves its barrier waits in ``wait`` (the next ``save`` or the end
of the loop), after rank 0's writer has committed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.plan import resolve_device
from repro_torch.sharding.partition import distribute

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]


def _flatten_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _tree_structure(tree):
    if isinstance(tree, dict):
        return {k: _tree_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_structure(v) for v in tree]
    return None


def _rebuild(structure, leaves_by_path, prefix=""):
    if isinstance(structure, dict):
        return {k: _rebuild(v, leaves_by_path, f"{prefix}/{k}")
                for k, v in structure.items()}
    if isinstance(structure, list):
        return [_rebuild(v, leaves_by_path, f"{prefix}/{i}")
                for i, v in enumerate(structure)]
    return leaves_by_path[prefix]


class _HostLeaf:
    """A leaf copied to the host: a numpy array of its own and the dtype
    name the manifest records."""

    def __init__(self, leaf):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()   # a collective: every rank, in the same order
        if torch.is_tensor(leaf):
            t = leaf.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                self.arr, self.dtype = t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
                return
            arr = t.numpy()
        else:
            arr = np.array(leaf)
        if arr.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: keep the bits
            self.arr, self.dtype = arr.view(np.uint16), "bfloat16"
        else:
            self.arr, self.dtype = arr, str(arr.dtype)


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    return _HostLeaf(tree)


def _mesh_of(tree):
    """The mesh of the tree's first DTensor leaf, or None."""
    for _, leaf in _flatten_with_paths(tree):
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def _writes(mesh) -> bool:
    """Whether this process writes: always off a mesh, else the mesh's rank 0."""
    return mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])


def _write(directory: Path, step: int, host_tree, extra: dict | None) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    tmp = directory / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)

    manifest = {"step": step, "format": 1, "extra": extra or {}, "leaves": []}
    for idx, (path, leaf) in enumerate(_flatten_with_paths(host_tree)):
        np.save(tmp / "arrays" / f"{idx}.npy", leaf.arr)
        manifest["leaves"].append(
            {"path": path, "idx": idx, "dtype": leaf.dtype, "shape": list(leaf.arr.shape)})
    manifest["structure"] = _tree_structure(host_tree)
    (tmp / "manifest.json").write_text(json.dumps(manifest))

    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    (directory / f"step_{step:09d}.COMMIT").write_text(str(step))
    return final


def save(directory: str | os.PathLike, step: int, tree: Any,
         extra: dict | None = None) -> Path:
    """Write a step-atomic checkpoint. Blocks until durable (on a mesh: until
    rank 0 has committed, on every rank)."""
    directory = Path(directory)
    mesh = _mesh_of(tree)
    host_tree = _host_tree(tree)
    try:
        if _writes(mesh):
            _write(directory, step, host_tree, extra)
    finally:
        if mesh is not None:
            dist.barrier()
    return directory / f"step_{step:09d}"


def latest_step(directory: str | os.PathLike) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.stem.split("_")[1]) for p in directory.glob("step_*.COMMIT")]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr, order="C")   # keeps 0-d leaves 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def restore(directory: str | os.PathLike, step: int | None = None,
            shardings: Any = None, target: Any = None, *,
            device=None) -> tuple[int, Any]:
    """Load a checkpoint → ``(step, tree of tensors on device)``.
    ``device=None`` is the card (raises without one). ``target``: optional
    tree to validate structure and shapes against. ``shardings``: a tree of
    ``NamedSharding`` with the checkpoint's structure; each leaf is then a
    DTensor on its sharding's mesh (and device type), ``device`` unused."""
    dev = resolve_device(device) if shardings is None else None
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {directory}")
    src = directory / f"step_{step:09d}"
    manifest = json.loads((src / "manifest.json").read_text())

    s_paths = dict(_flatten_with_paths(shardings)) if shardings is not None else None
    leaves = {}
    for meta in manifest["leaves"]:
        arr = np.load(src / "arrays" / f"{meta['idx']}.npy")
        if s_paths is None:
            leaves[meta["path"]] = _tensor(arr, meta["dtype"], dev)
        else:
            sh = s_paths[meta["path"]]
            leaves[meta["path"]] = distribute(
                _tensor(arr, meta["dtype"], torch.device(sh.mesh.device_type)), sh)
    tree = _rebuild(manifest["structure"], leaves)

    if target is not None:
        t_paths = dict(_flatten_with_paths(target))
        got = dict(_flatten_with_paths(tree))
        if set(t_paths) != set(got):
            missing = set(t_paths) ^ set(got)
            raise ValueError(f"checkpoint/target structure mismatch: {sorted(missing)[:5]}")
        for p, leaf in t_paths.items():
            if tuple(leaf.shape) != tuple(got[p].shape):
                raise ValueError(f"shape mismatch at {p}: "
                                 f"{tuple(got[p].shape)} vs {tuple(leaf.shape)}")
    return step, tree


class AsyncCheckpointer:
    """One-in-flight background writer (overlaps ckpt I/O with training)."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._barrier = False   # a mesh save whose barrier ``wait`` still owes

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()  # join the previous write (double buffer of depth 1)
        # Copy to host memory BEFORE returning control: the next step
        # updates the parameters and the optimizer state in place. A
        # device-to-host ``.to("cpu")`` waits for the card's pending work;
        # a CPU tensor is cloned.
        mesh = _mesh_of(tree)
        host_tree = _host_tree(tree)
        self._barrier = mesh is not None
        if not _writes(mesh):
            return

        def _run():
            try:
                _write(self.directory, step, host_tree, extra)
                self._gc()
            except Exception as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:   # every rank of the mesh, after rank 0's commit
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        commits = sorted(self.directory.glob("step_*.COMMIT"))
        for old in commits[: -self.keep]:
            step_dir = self.directory / old.stem
            old.unlink(missing_ok=True)
            if step_dir.exists():
                shutil.rmtree(step_dir, ignore_errors=True)
