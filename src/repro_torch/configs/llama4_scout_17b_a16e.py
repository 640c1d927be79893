"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) vocab=202048,
MoE 16 routed experts top-1 (d_ff 8192) + 1 shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E].

iRoPE-style attention interleave: 3 chunked-causal RoPE layers then 1 global
NoPE layer. 16 experts / 16-way TP => "ep" expert sharding (all-to-all
dispatch), the collective-heavy MoE cell of the sweep. 40 heads do not divide
16 — GSPMD pads internally (see DESIGN.md §4).
"""
from .base import AttnSpec, BlockSpec, ModelConfig, MoESpec

_MOE = MoESpec(
    num_experts=16,
    top_k=1,
    d_ff_expert=8192,
    num_shared=1,
    d_ff_shared=8192,
    sharding="ep",
    norm_topk=False,  # top-1: sigmoid-style single gate, no renorm
)
_CHUNKED = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="chunked", chunk=8192, rope=True, rope_theta=500_000.0),
    ffn="none",
    moe=_MOE,
)
_GLOBAL_NOPE = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="global", rope=False),
    ffn="none",
    moe=_MOE,
)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        pattern=(_CHUNKED, _CHUNKED, _CHUNKED, _GLOBAL_NOPE),
        n_repeats=12,
        grad_accum=8,
    )


def smoke_config() -> ModelConfig:
    import dataclasses

    moe = dataclasses.replace(_MOE, num_experts=4, d_ff_expert=32, d_ff_shared=32)
    chunked = dataclasses.replace(
        _CHUNKED, moe=moe, attn=dataclasses.replace(_CHUNKED.attn, chunk=8)
    )
    gl = dataclasses.replace(_GLOBAL_NOPE, moe=moe)
    return ModelConfig(
        name="llama4-scout-17b-a16e-smoke",
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        pattern=(chunked, gl),
        n_repeats=2,
        act_dtype="float32",
    )
