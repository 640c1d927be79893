"""Model stack of the port: layers, attention, recurrent mixers, MoE and
pattern models, the JAX package's ``repro/models`` in plain PyTorch (the JAX
package has no kernel on this path either: attention, MoE dispatch and the
recurrences are ``jnp`` there).

Parameters and caches are nested dicts of tensors in the JAX layout;
:func:`params_from_jax` and :func:`caches_from_jax` carry the JAX
package's trees over, :func:`init_params` draws the port's own, and
:func:`param_logical_axes` / :func:`cache_logical_axes` name each leaf's
logical sharding axes."""
from .model import (
    cache_logical_axes,
    caches_from_jax,
    forward,
    init_caches,
    init_params,
    model_flops_per_token,
    param_logical_axes,
    params_from_jax,
    splice_cache,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

__all__ = [
    "cache_logical_axes",
    "caches_from_jax",
    "forward",
    "init_caches",
    "init_params",
    "model_flops_per_token",
    "param_logical_axes",
    "params_from_jax",
    "splice_cache",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
]
