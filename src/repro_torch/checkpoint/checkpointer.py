"""Low-level checkpoint IO: tree of tensors <-> npz with atomic writes, the
port of the JAX package's ``repro/checkpoint/checkpointer.py``, in its
on-disk layout.

``arrays.npz`` holds every leaf of a nested dict as a full host array keyed
by its ``|``-joined tree path (``params|pattern|block0|...``, ``opt|m|...``, ``opt|step``), in
JAX's leaf order, and ``meta.json`` the metadata, so a checkpoint written by
either package restores in the other bit for bit. bfloat16 leaves are stored
as JAX stores them, two raw bytes each (numpy's ``V2``), without
``ml_dtypes``. Writes go to a temp dir + atomic rename; a partially written
checkpoint is never visible.

DTensor leaves (state laid out on a ``DeviceMesh``) are gathered whole with
``full_tensor()`` on the calling thread, every rank taking part; in a
process group of several ranks only rank 0 writes and the others wait at a
barrier. The layout on disk is the same, so a checkpoint written under one
mesh restores under any other, and in the JAX package.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.model import tree_unflatten
from repro_torch.sharding.compat import is_dtensor
from repro_torch.sharding.partitioning import device_put

__all__ = ["save_pytree", "load_pytree", "load_meta", "tree_paths", "is_writer", "group_barrier"]

_SEP = "|"


def tree_paths(tree) -> dict:
    """``{path: leaf}`` of a nested dict in JAX's leaf order (keys sorted at
    every level, as :func:`repro_torch.models.tree_leaves` walks them);
    ``None`` is no leaf."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif t is not None:
            out[_SEP.join(path)] = t

    walk(tree, ())
    return out


def _grouped() -> bool:
    """True inside a process group of more than one rank."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def is_writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group
    of several ranks, or the process alone."""
    import torch.distributed as dist

    return not _grouped() or dist.get_rank() == 0


def group_barrier() -> None:
    """A barrier over the process group when it has several ranks."""
    if _grouped():
        import torch.distributed as dist

        dist.barrier()


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective: every rank calls it); a
    plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _host_array(leaf) -> np.ndarray:
    """A leaf (tensor, DTensor, numpy array or number) as a host numpy
    array; bf16 as its raw two bytes (``V2``), the bytes JAX writes for it."""
    if isinstance(leaf, torch.Tensor):
        t = _full(leaf.detach()).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree, meta: Optional[dict] = None) -> None:
    """Atomic: write into ``<path>.tmp.*`` then rename to ``<path>``. In a
    process group of several ranks only rank 0 writes; a tree of DTensors
    is saved by every rank (each leaf is gathered), and every rank returns
    after rank 0's write."""
    leaves = tree_paths(tree)
    gathered = any(is_dtensor(v) for v in leaves.values())
    arrays = {k: _host_array(v) for k, v in leaves.items()}
    try:
        if is_writer():
            _write(path, arrays, meta)
    finally:
        if gathered:
            group_barrier()


def _write(path: str, arrays: dict, meta: Optional[dict]) -> None:
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp.", dir=parent)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta or {}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _as_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype`` (cast as numpy's
    ``astype`` casts; ``V2`` is bf16's raw bytes)."""
    arr = np.asarray(arr, order="C")
    if arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dtype)
    return torch.from_numpy(arr).to(dtype)


def load_pytree(path: str, like, device=None, shardings=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors or meta
    tensors, JAX's ``ShapeDtypeStruct``), each leaf cast to its ``like``
    leaf's dtype, on ``device`` (default: the CUDA card). A key missing from
    the checkpoint or a shape that differs raises ``ValueError``. Only the
    keys ``like`` names are read.

    ``shardings``: an optional matching tree of ``NamedSharding``s (as in
    JAX). Each such leaf is read on the host and laid out straight onto its
    mesh (``device_put``: this rank's shard only goes to the device), one
    leaf at a time, so the full state is never on any device at once."""
    shard_paths = tree_paths(shardings) if shardings is not None else {}
    like_paths = tree_paths(like)
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        missing = set(like_paths) - set(z.files)
        if missing:
            raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
        for key, leaf in like_paths.items():
            arr = z[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
            t = _as_tensor(arr, leaf.dtype)
            del arr
            leaves.append(device_put(t, shard_paths[key]) if key in shard_paths else t.to(resolve_device(device)))
            del t
    return tree_unflatten(like, leaves)


def load_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)
