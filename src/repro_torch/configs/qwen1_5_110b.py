"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064. QKV bias [hf:Qwen/Qwen1.5-110B]."""
from .base import AttnSpec, BlockSpec, ModelConfig

_BLOCK = BlockSpec(
    kind="attn",
    attn=AttnSpec(kind="global", rope=True, rope_theta=1_000_000.0, qkv_bias=True),
    ffn="swiglu",
)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        pattern=(_BLOCK,),
        n_repeats=80,
        grad_accum=16,  # keep per-shard microbatch at 1 for the 1M-token step
        # int8 KV cache halves decode-cache HBM: the decode_32k cell fits a
        # 16 GiB chip only with this on (see EXPERIMENTS.md §Perf)
        kv_cache_dtype="int8",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b-smoke",
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=384,
        vocab_size=256,
        pattern=(_BLOCK,),
        n_repeats=3,
        act_dtype="float32",
    )
