"""stablelm-1.6b [dense]: 24L d_model=2048 32H (kv=32 -> MHA) d_ff=5632
vocab=100352. Partial rotary (25%), LayerNorm [hf:stabilityai/stablelm-2-1_6b]."""
from .base import AttnSpec, BlockSpec, ModelConfig

_BLOCK = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="global", rope=True, rope_fraction=0.25),
    ffn="swiglu",
)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab_size=100352,
        pattern=(_BLOCK,),
        n_repeats=24,
        norm="layernorm",
        grad_accum=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b-smoke",
        d_model=96,
        n_heads=6,
        n_kv_heads=6,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
        pattern=(_BLOCK,),
        n_repeats=2,
        norm="layernorm",
        act_dtype="float32",
    )
