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

__all__ = ["save_pytree", "load_pytree", "load_meta", "tree_paths"]

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


def _host_array(leaf) -> np.ndarray:
    """A leaf (tensor, numpy array or number) as a host numpy array; bf16
    as its raw two bytes (``V2``), the bytes JAX writes for it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree, meta: Optional[dict] = None) -> None:
    """Atomic: write into ``<path>.tmp.*`` then rename to ``<path>``."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp.", dir=parent)
    try:
        arrays = {k: _host_array(v) for k, v in tree_paths(tree).items()}
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


def load_pytree(path: str, like, device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors or meta
    tensors, JAX's ``ShapeDtypeStruct``), each leaf cast to its ``like``
    leaf's dtype, on ``device`` (default: the CUDA card). A key missing from
    the checkpoint or a shape that differs raises ``ValueError``. Only the
    keys ``like`` names are read."""
    dev = resolve_device(device)
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
            leaves.append(_as_tensor(arr, leaf.dtype).to(dev))
            del arr
    return tree_unflatten(like, leaves)


def load_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)
