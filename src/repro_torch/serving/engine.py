"""Slot-based continuous-batching serving engine: the port of the JAX
package's ``repro/serving/engine.py``.

A fixed decode batch of ``max_slots`` runs every step; requests stream in
and out of slots independently (vLLM-style continuous batching,
slot-granular):

  submit()  - prefill the prompt at batch=1, splice its cache into the slot;
  step()    - one batched decode for every slot (inactive ones too, as in
              JAX: the batch keeps its shape); finished requests (eos /
              max_tokens) free their slots immediately.

The JAX engine jits its two steps (``jax.jit``); the port calls them
eagerly. Tokens and positions stay on the engine's device; the sampled
tokens come to the host once per step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, init_caches, splice_cache

from .sampling import greedy

__all__ = ["ServeEngine", "Request", "make_serve_step", "make_prefill"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list
    max_tokens: int
    eos_id: int = -1
    generated: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False


def make_serve_step(cfg: ModelConfig):
    """(params, caches, tokens (B,1), positions (B,)) -> (logits, caches)."""

    def serve_step(params, caches, tokens, positions):
        logits, new_caches, _ = forward(params, cfg, tokens=tokens, positions=positions[:, None],
                                        mode="decode", caches=caches)
        return logits[:, 0], new_caches

    return serve_step


def make_prefill(cfg: ModelConfig):
    """(params, caches, tokens (B,S)) -> (last logits (B,V), caches)."""

    def prefill(params, caches, tokens):
        logits, new_caches, _ = forward(params, cfg, tokens=tokens, mode="prefill", caches=caches)
        return logits[:, -1], new_caches

    return prefill


def _device_of(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class ServeEngine:
    """Continuous batching over ``max_slots`` slots of ``max_len`` tokens on
    ``device`` (default: the CUDA card), where ``params`` must live."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        max_slots: int = 4,
        max_len: int = 256,
        sampler: Callable = greedy,
        device=None,
    ):
        self.device = resolve_device(device)
        if _device_of(params) != self.device:
            raise ValueError(f"params live on {_device_of(params)}, the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.sampler = sampler
        self.caches = init_caches(cfg, max_slots, max_len, device=self.device)
        self.positions = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
        self.last_token = torch.zeros((max_slots,), dtype=torch.int64, device=self.device)
        self.active = [False] * max_slots
        self.requests: Dict[int, Request] = {}
        self.slot_to_uid: List[Optional[int]] = [None] * max_slots
        self._finished_at_prefill: List[Request] = []
        self._decode = make_serve_step(cfg)
        self._prefill = make_prefill(cfg)

    # ------------------------------------------------------------ requests
    def submit(self, req: Request) -> bool:
        """Prefill into a free slot; False if engine is full or uid known."""
        if req.uid in self.requests and not self.requests[req.uid].done:
            return False  # already in flight
        if req.done:
            return False
        try:
            slot = self.active.index(False)
        except ValueError:
            return False
        toks = torch.tensor([req.prompt], dtype=torch.int64, device=self.device)
        one_cache = init_caches(self.cfg, 1, self.max_len, device=self.device)
        last_logits, one_cache = self._prefill(self.params, one_cache, toks)
        # splice the single-request cache into the batched slot
        self.caches = splice_cache(self.caches, one_cache, slot)
        nxt = int(self.sampler(last_logits)[0])
        self.positions[slot] = len(req.prompt)
        self.last_token[slot] = nxt
        req.generated.append(nxt)
        req.slot = slot
        self.requests[req.uid] = req
        # the prefill-sampled token can already end the request (eos or a
        # max_tokens budget of 1): it never takes a decode slot then, but
        # step() still reports it among the finished
        if nxt == req.eos_id or len(req.generated) >= req.max_tokens:
            req.done = True
            self._finished_at_prefill.append(req)
            return True
        self.active[slot] = True
        self.slot_to_uid[slot] = req.uid
        return True

    # ---------------------------------------------------------------- step
    def step(self) -> List[Request]:
        """One batched decode step; returns requests finished since the last
        step (including any that terminated already at prefill)."""
        finished = self._finished_at_prefill
        self._finished_at_prefill = []
        if not any(self.active):
            return finished
        logits, self.caches = self._decode(self.params, self.caches, self.last_token[:, None],
                                           self.positions)
        nxt = self.sampler(logits)
        active = torch.tensor(self.active, device=self.device)
        self.positions = self.positions + active.to(torch.int32)
        self.last_token = torch.where(active, nxt, self.last_token)
        tokens = nxt.tolist()
        positions = self.positions.tolist()
        for slot, uid in enumerate(self.slot_to_uid):
            if uid is None or not self.active[slot]:
                continue
            req = self.requests[uid]
            tok = tokens[slot]
            req.generated.append(tok)
            hit_eos = tok == req.eos_id
            hit_max = len(req.generated) >= req.max_tokens
            if hit_eos or hit_max or positions[slot] >= self.max_len - 1:
                req.done = True
                self.active[slot] = False
                self.slot_to_uid[slot] = None
                finished.append(req)
        return finished

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not any(self.active):
                return
            self.step()
