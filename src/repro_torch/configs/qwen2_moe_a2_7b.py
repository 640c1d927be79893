"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16 MHA) vocab=151936,
MoE 60 routed experts top-4 (d_ff 1408 each) + 4 shared experts (5632 total)
[hf:Qwen/Qwen1.5-MoE-A2.7B].

60 experts do not divide the 16-way TP axis, so this arch uses "tp" expert
sharding (expert hidden dim over the model axis); llama4-scout exercises "ep".
"""
from .base import AttnSpec, BlockSpec, ModelConfig, MoESpec

_MOE = MoESpec(
    num_experts=60,
    top_k=4,
    d_ff_expert=1408,
    num_shared=1,  # one fused shared-expert FFN of the combined width
    d_ff_shared=5632,
    sharding="tp",
    norm_topk=True,
)
_BLOCK = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="global", rope=True, rope_theta=1_000_000.0, qkv_bias=True),
    ffn="none",
    moe=_MOE,
)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151936,
        pattern=(_BLOCK,),
        n_repeats=24,
        grad_accum=4,
    )


def smoke_config() -> ModelConfig:
    import dataclasses

    moe = dataclasses.replace(
        _MOE, num_experts=8, top_k=2, d_ff_expert=32, d_ff_shared=64
    )
    block = dataclasses.replace(_BLOCK, moe=moe)
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke",
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        pattern=(block,),
        n_repeats=2,
        act_dtype="float32",
    )
