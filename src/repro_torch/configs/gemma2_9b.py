"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
Local(4096)+global alternating, attn softcap 50, final softcap 30, pre+post
RMSNorm(1+w), GeGLU, tied embeddings, sqrt(d) embedding scale
[arXiv:2408.00118]."""
from .base import AttnSpec, BlockSpec, ModelConfig

_LOCAL = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="local", window=4096, rope=True, softcap=50.0),
    ffn="geglu",
    post_norm=True,
)
_GLOBAL = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="global", rope=True, softcap=50.0),
    ffn="geglu",
    post_norm=True,
)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        pattern=(_LOCAL, _GLOBAL),
        n_repeats=21,
        norm="rmsnorm_p1",
        tie_embeddings=True,
        logit_softcap=30.0,
        emb_scale=True,
        grad_accum=4,
    )


def smoke_config() -> ModelConfig:
    import dataclasses

    local = dataclasses.replace(
        _LOCAL, attn=dataclasses.replace(_LOCAL.attn, window=8)
    )
    return ModelConfig(
        name="gemma2-9b-smoke",
        d_model=96,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=192,
        vocab_size=256,
        pattern=(local, _GLOBAL),
        n_repeats=2,
        norm="rmsnorm_p1",
        tie_embeddings=True,
        logit_softcap=30.0,
        emb_scale=True,
        act_dtype="float32",
    )
