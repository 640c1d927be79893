"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504 —
encoder-only transformer over audio frames [arXiv:2106.07447].

The conv waveform frontend is a STUB per the assignment: input_specs()
provides precomputed frame embeddings (B, S, d_model). No decode step
(encoder-only) => decode_32k / long_500k cells are skipped. The BG denoiser
can run over input spectrograms in the data pipeline (DESIGN.md
§Arch-applicability).
"""
from .base import AttnSpec, BlockSpec, ModelConfig

_BLOCK = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="global", rope=False, causal=False),
    ffn="gelu",
)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        pattern=(_BLOCK,),
        n_repeats=48,
        norm="layernorm",
        encoder_only=True,
        frontend="audio",
        grad_accum=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke",
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=64,
        pattern=(_BLOCK,),
        n_repeats=2,
        norm="layernorm",
        encoder_only=True,
        frontend="audio",
        act_dtype="float32",
    )
