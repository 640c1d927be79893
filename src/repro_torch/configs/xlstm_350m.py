"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517]. d_ff=0: the mixers carry their own projections
(projection factor 2 up/down inside the mLSTM block), no separate FFN.

Pattern [mLSTM x3, sLSTM] x6 = 24 layers (the paper's mostly-mLSTM ratio).
Sub-quadratic decode state => eligible for long_500k.
"""
from .base import BlockSpec, ModelConfig

_M = BlockSpec(kind="mlstm", ffn="none")
_S = BlockSpec(kind="slstm", ffn="none")


def full_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        pattern=(_M, _M, _M, _S),
        n_repeats=6,
        rnn_width=2048,
        # chunkwise mLSTM keeps memory linear in S; accum 4 balances the
        # activation footprint (see EXPERIMENTS.md §Perf for the hillclimb)
        grad_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke",
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        head_dim=32,
        d_ff=0,
        vocab_size=256,
        pattern=(_M, _S),
        n_repeats=2,
        rnn_width=128,
        act_dtype="float32",
    )
