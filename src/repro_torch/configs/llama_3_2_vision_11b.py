"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th block
[hf:meta-llama/Llama-3.2-11B-Vision].

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, 1601, d_model) as the cross-attention
context. The BG denoiser (this paper) runs as the image-preprocessing stage in
the data pipeline (see repro_torch.data.pipeline and the
repro_torch.examples.vlm_preprocess example).
"""
from .base import AttnSpec, BlockSpec, ModelConfig

_SELF = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="global", rope=True, rope_theta=500_000.0),
    ffn="swiglu",
)
_CROSS = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="global", rope=True, rope_theta=500_000.0),
    ffn="swiglu",
    cross_attn=True,
)

VISION_TOKENS = 1601  # (560/14)^2 + cls


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        pattern=(_SELF, _SELF, _SELF, _SELF, _CROSS),
        n_repeats=8,
        frontend="vision",
        cross_attn_tokens=VISION_TOKENS,
        grad_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-smoke",
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        pattern=(_SELF, _CROSS),
        n_repeats=2,
        frontend="vision",
        cross_attn_tokens=17,
        act_dtype="float32",
    )
