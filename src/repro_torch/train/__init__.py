"""LM training of the port: AdamW and its schedule, the train step with
gradient accumulation (and the model's remat), the fault-tolerant
``Trainer`` and int8 gradient compression, the JAX package's
``repro/train`` in plain PyTorch with autograd (the JAX package has no
kernel on this path: ``jax.value_and_grad`` differentiates plain ``jnp``)."""
from .grad_compress import compressed_mean_grads, quantize_dequantize_roundtrip
from .optimizer import OptConfig, adamw_init, adamw_update, global_norm, lr_at_step
from .train_step import init_train_state, loss_fn, make_train_step
from .trainer import Trainer

__all__ = [
    "OptConfig",
    "Trainer",
    "adamw_init",
    "adamw_update",
    "compressed_mean_grads",
    "global_norm",
    "init_train_state",
    "loss_fn",
    "lr_at_step",
    "make_train_step",
    "quantize_dequantize_roundtrip",
]
