"""CheckpointManager: step-indexed, retention-limited, async-capable,
resume-from-latest: the port of the JAX package's
``repro/checkpoint/manager.py``.

Failure model covered:
  * preemption/SIGTERM  -> the trainer triggers ``save_sync()`` then exits;
  * crash mid-save      -> atomic rename means the last good step is intact;
  * async save          -> ``save()`` copies every leaf to the host before
                           it returns (JAX's ``device_get``), and a worker
                           thread writes that snapshot, so the train loop
                           may change its tensors at once and never blocks
                           on disk. One save is in flight at a time; its
                           error is raised by the next ``wait()``.

On DTensor state the snapshot gathers each leaf whole (``full_tensor()``)
on the calling thread, every rank taking part: never on the writer thread,
where the ranks' collectives would not line up. In a process group of
several ranks only rank 0 writes (and prunes); every rank meets the others
at a barrier in ``wait()``, after rank 0's write has finished.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Optional

import torch

from repro_torch.models.model import tree_map

from .checkpointer import _full, group_barrier, is_writer, load_meta, load_pytree, save_pytree

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _snapshot(tree):
    """A host copy of every tensor of ``tree`` (DTensors gathered whole;
    other leaves as they are)."""
    return tree_map(lambda t: _full(t.detach()).to("cpu", copy=True) if isinstance(t, torch.Tensor) else t, tree)


class CheckpointManager:
    def __init__(self, directory: str, retention: int = 3, async_save: bool = True):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.retention = retention
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier_due = False

    # ----------------------------------------------------------- inventory
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree, meta: Optional[dict] = None):
        """Async (default): snapshot to host, write on a worker thread."""
        self.wait()  # one in-flight save at a time; surfaces prior errors
        meta = dict(meta or {}, step=step)
        snapshot = _snapshot(tree)
        self._barrier_due = True
        if not is_writer():
            if not self.async_save:
                self.wait()
            return

        def work():
            try:
                save_pytree(self._path(step), snapshot, meta)  # a host snapshot: no gather, no barrier
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def save_sync(self, step: int, tree, meta: Optional[dict] = None):
        prev = self.async_save
        self.async_save = False
        try:
            self.save(step, tree, meta)
        finally:
            self.async_save = prev

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier_due:
            self._barrier_due = False
            group_barrier()
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.retention] if self.retention else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ------------------------------------------------------------- restore
    def restore(self, like, step: Optional[int] = None, device=None, shardings=None):
        """Returns ``(tree, meta)``. ``like`` may be tensors or meta
        tensors; leaves land on ``device`` (default: the CUDA card), or,
        where the optional ``shardings`` tree has one, straight onto its
        mesh (see :func:`load_pytree`)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self._path(step)
        return load_pytree(path, like, device, shardings), load_meta(path)
