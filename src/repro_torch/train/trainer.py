"""Trainer: the fault-tolerant training loop, the port of the JAX package's
``repro/train/trainer.py``.

Features (as in JAX):
  * auto-resume from the latest checkpoint (the restore's ``like`` tree is
    built on the meta device: a full-width model is never drawn only to be
    replaced);
  * periodic async checkpointing + retention;
  * SIGTERM/SIGINT preemption hook -> synchronous save -> clean exit;
  * heartbeat file (step, timestamp, step_time) for external watchdogs;
  * step-time EWMA + ``straggler_suspect`` on slow steps.

The port's differences: ``device=`` (default: the CUDA card; ``"cpu"`` only
when asked), the step runs eagerly (as ``ServeEngine``'s do), and it
updates the parameters and optimizer state in place (``make_train_step(...,
donate=True)``), the port's form of JAX's ``donate_argnums``. On DTensor
state (a ``DeviceMesh``) every rank runs the loop: a resume under
``set_mesh`` puts each restored leaf straight onto the active mesh
(``checkpoint.elastic``'s rules), the checkpoints gather it and rank 0
writes them and the heartbeat.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Callable, Iterator, Optional


from repro_torch._device import resolve_device
from repro_torch.checkpoint.checkpointer import is_writer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_params
from repro_torch.sharding.compat import get_active_mesh
from repro_torch.sharding.partitioning import current_rules
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step

__all__ = ["Trainer"]


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: OptConfig,
        ckpt_dir: str,
        ckpt_every: int = 100,
        retention: int = 3,
        heartbeat_path: Optional[str] = None,
        slow_step_factor: float = 3.0,
        device=None,
    ):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir, retention=retention)
        self.ckpt_every = ckpt_every
        self.heartbeat_path = heartbeat_path or os.path.join(ckpt_dir, "heartbeat.json")
        self.slow_step_factor = slow_step_factor
        self._preempted = False
        self.step = 0
        self.params = None
        self.opt_state = None
        # seconds the loop spent in each save call (a wait for the save in
        # flight, then the host snapshot; a sync save also writes)
        self.save_seconds: list = []
        self.train_step = make_train_step(cfg, opt_cfg, donate=True)

    # ----------------------------------------------------------- lifecycle
    def init_or_resume(self, seed: int = 0):
        latest = self.ckpt.latest_step()
        if latest is not None:
            like_p = init_params(seed, self.cfg, device="meta")
            like_o = init_train_state(like_p)
            mesh, shardings = get_active_mesh(), None
            if mesh is not None:  # elastic: each leaf straight onto whatever mesh is active now
                from repro_torch.checkpoint.elastic import train_state_shardings

                p_sh, o_sh = train_state_shardings(self.cfg, mesh, current_rules())
                shardings = {"params": p_sh, "opt": o_sh}
            state, meta = self.ckpt.restore({"params": like_p, "opt": like_o}, device=self.device,
                                            shardings=shardings)
            self.params, self.opt_state = state["params"], state["opt"]
            self.step = int(meta["step"])
            return "resumed"
        self.params = init_params(seed, self.cfg, device=self.device)
        self.opt_state = init_train_state(self.params)
        self.step = 0
        return "initialized"

    def _install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _heartbeat(self, step: int, step_time: float):
        if not is_writer():
            return
        tmp = self.heartbeat_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time(), "step_time": step_time}, f)
        os.replace(tmp, self.heartbeat_path)

    def _save(self, sync=False):
        state = {"params": self.params, "opt": self.opt_state}
        meta = {"step": self.step, "config": self.cfg.name}
        t0 = time.perf_counter()
        (self.ckpt.save_sync if sync else self.ckpt.save)(self.step, state, meta)
        self.save_seconds.append({"step": self.step, "sync": sync, "seconds": time.perf_counter() - t0})

    # ----------------------------------------------------------------- run
    def run(
        self,
        batches: Iterator[dict],
        max_steps: int,
        log_fn: Callable[[int, dict], None] = lambda s, m: None,
    ):
        """Returns the final metrics dict. Stops early (with a checkpoint) on
        preemption. Batches hold numpy arrays or tensors."""
        self._install_preemption_handler()
        ewma = None
        metrics = {}
        for batch in batches:
            if self.step >= max_steps or self._preempted:
                break
            t0 = time.monotonic()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch
            )
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
            dt = time.monotonic() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            self.step += 1
            metrics["step_time"] = dt
            if dt > self.slow_step_factor * ewma:
                metrics["straggler_suspect"] = True
            self._heartbeat(self.step, dt)
            log_fn(self.step, metrics)
            if self.step % self.ckpt_every == 0:
                self._save()
        # final/preemption checkpoint
        self._save(sync=True)
        self.ckpt.wait()
        return metrics
