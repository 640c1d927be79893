"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — Griffin: RG-LRU recurrent blocks + local attention, 2:1
[arXiv:2402.19427].

Pattern (rec, rec, local-attn) x12 + 2 recurrent tail layers = 38. Bounded
state (RG-LRU h + 2048-token local window) => eligible for long_500k.
"""
from .base import AttnSpec, BlockSpec, ModelConfig

_REC = BlockSpec(kind="rglru", ffn="geglu")
_ATTN = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="local", window=2048, rope=True),
    ffn="geglu",
)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        pattern=(_REC, _REC, _ATTN),
        n_repeats=12,
        tail=(_REC, _REC),
        rnn_width=4096,
        norm="rmsnorm_p1",
        tie_embeddings=True,
        emb_scale=True,
        grad_accum=4,
    )


def smoke_config() -> ModelConfig:
    import dataclasses

    attn = dataclasses.replace(
        _ATTN, attn=dataclasses.replace(_ATTN.attn, window=8)
    )
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=(_REC, _REC, attn),
        n_repeats=2,
        tail=(_REC,),
        rnn_width=64,
        norm="rmsnorm_p1",
        tie_embeddings=True,
        emb_scale=True,
        act_dtype="float32",
    )
