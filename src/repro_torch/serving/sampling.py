"""Token sampling strategies for the serving engine: the port of the JAX
package's ``repro/serving/sampling.py``. Random samplers take a
``torch.Generator`` (JAX's PRNG key) on the logits' device; bind it with
``functools.partial`` to make an engine's ``sampler``."""
from __future__ import annotations

import torch

__all__ = ["greedy", "sample_temperature", "sample_topk"]


def greedy(logits: torch.Tensor, generator=None) -> torch.Tensor:
    """The first largest logit of each row (``jnp.argmax``'s tie rule)."""
    return torch.argmax(logits, dim=-1)


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` by the Gumbel-max trick, as
    ``jax.random.categorical`` draws."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.to(torch.float32) - torch.log(-torch.log(u)), dim=-1)


def sample_temperature(logits: torch.Tensor, generator: torch.Generator, temperature: float = 1.0):
    return _categorical(logits / max(temperature, 1e-4), generator)


def sample_topk(logits: torch.Tensor, generator: torch.Generator, k: int = 40,
                temperature: float = 1.0):
    """A draw among each row's ``k`` largest logits (ties to the lower
    index, as ``jax.lax.top_k``), at ``temperature``."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    choice = _categorical(vals / max(temperature, 1e-4), generator)
    return torch.gather(idx, -1, choice[..., None])[..., 0]
