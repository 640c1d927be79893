"""The comparison that decides ``correct``: the program's quantized frames
against the plain reference's, frame by frame.

Two numbers, each held to the configuration's limit:

  max_lsb         the largest absolute difference of any compared pixel, in
                  8-bit steps (the configuration's stated guarantee: at
                  most 1 apart);
  mismatch_share  the largest share, over the compared frames, of a frame's
                  pixels that differ from the reference at all.

A non-finite output pixel counts as differing, by an unbounded amount.
"""
from __future__ import annotations

import torch

__all__ = ["Verdict"]

_UNBOUNDED = 1e9  # a difference that JSON can carry, for a non-finite pixel


class Verdict:
    def __init__(self, limits: dict):
        self.limits = {"max_lsb": float(limits["max_lsb"]),
                       "mismatch_share": float(limits["mismatch_share"])}
        self.max_lsb = 0.0
        self.mismatch_share = 0.0
        self.frames = 0

    def add(self, program: torch.Tensor, reference: torch.Tensor) -> None:
        """Compare (n, h, w) or (h, w) quantized frames."""
        program = program.to(torch.float32).reshape(-1, *program.shape[-2:])
        reference = reference.to(program.device, torch.float32).reshape(program.shape)
        diff = torch.nan_to_num((program - reference).abs(), nan=_UNBOUNDED, posinf=_UNBOUNDED)
        per_frame = (diff > 0).flatten(1).float().mean(1)
        self.max_lsb = max(self.max_lsb, float(diff.max()))
        self.mismatch_share = max(self.mismatch_share, float(per_frame.max()))
        self.frames += program.shape[0]

    @property
    def correct(self) -> bool:
        return (self.frames > 0 and self.max_lsb <= self.limits["max_lsb"]
                and self.mismatch_share <= self.limits["mismatch_share"])

    def numbers(self) -> dict:
        """Each compared number beside its limit, and the frames compared."""
        return {"frames_checked": self.frames,
                "max_lsb": {"value": self.max_lsb, "limit": self.limits["max_lsb"]},
                "mismatch_share": {"value": self.mismatch_share,
                                   "limit": self.limits["mismatch_share"]}}
