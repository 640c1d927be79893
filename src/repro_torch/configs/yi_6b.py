"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
Llama-arch GQA [arXiv:2403.04652]."""
from .base import AttnSpec, BlockSpec, ModelConfig

_BLOCK = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="global", rope=True, rope_theta=5_000_000.0),
    ffn="swiglu",
)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        pattern=(_BLOCK,),
        n_repeats=32,
        grad_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke",
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        pattern=(_BLOCK,),
        n_repeats=2,
        act_dtype="float32",
    )
