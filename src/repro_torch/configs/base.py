"""Model/architecture configuration dataclasses: the port's copy of the JAX
package's ``repro/configs/base.py``, field for field, so that one config
describes the same model in both packages.

Every architecture is a *repeating pattern* of heterogeneous blocks scanned
``n_repeats`` times (compile-time critical at 40-80 layers), plus optional
unrolled tail blocks. All dataclasses are frozen/hashable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["AttnSpec", "MoESpec", "BlockSpec", "ModelConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    kind: str = "global"  # "global" | "local" | "chunked"
    window: int = 0  # local-attention window (tokens)
    chunk: int = 0  # llama4 chunked-causal width
    softcap: float = 0.0  # gemma2 attention-logit softcap
    rope: bool = True
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # stablelm partial rotary
    qkv_bias: bool = False  # qwen
    causal: bool = True  # False for encoder-only


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0
    dispatch: str = "einsum"  # "einsum" (GShard baseline) | "ragged" (sorted)
    sharding: str = "tp"  # "tp" (expert hidden dim over TP) | "ep" (experts over TP)
    capacity_factor: float = 1.25
    group_size: int = 2048  # GShard dispatch group (keeps (G,E,C) tensors bounded)
    norm_topk: bool = True  # renormalize top-k router probs
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str = "attn"  # "attn" | "rglru" | "mlstm" | "slstm"
    attn: Optional[AttnSpec] = None
    ffn: str = "swiglu"  # "swiglu" | "geglu" | "gelu" | "none"
    moe: Optional[MoESpec] = None
    cross_attn: bool = False  # vision-text cross-attn sublayer
    post_norm: bool = False  # gemma2 post-sublayer RMSNorm


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[BlockSpec, ...]
    n_repeats: int
    tail: Tuple[BlockSpec, ...] = ()
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm" | "rmsnorm_p1" (gemma 1+w)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    emb_scale: bool = False  # gemma sqrt(d_model) embedding scale
    encoder_only: bool = False
    frontend: Optional[str] = None  # None | "vision" | "audio"
    cross_attn_tokens: int = 0  # vision-context length for cross-attn
    frontend_dim: int = 0  # stub frontend embedding width
    # recurrent dims (griffin / xlstm)
    rnn_width: int = 0
    conv1d_width: int = 4
    # numerics
    act_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"  # "int8": KIVI-style per-token KV quant
    # training
    remat: str = "full"  # "full" | "dots" | "none"
    grad_accum: int = 1  # microbatch steps inside train_step
    max_seq_len: int = 8192

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_repeats + len(self.tail)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        d = self.d_model
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        blocks = list(self.pattern) * self.n_repeats + list(self.tail)
        for b in blocks:
            total += self._block_params(b)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k counting), for MODEL_FLOPS."""
        d = self.d_model
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        blocks = list(self.pattern) * self.n_repeats + list(self.tail)
        for b in blocks:
            total += self._block_params(b, active_only=True)
        return total

    def _block_params(self, b: BlockSpec, active_only: bool = False) -> int:
        d = self.d_model
        n = 0
        if b.kind == "attn":
            q = self.n_heads * self.head_dim
            kv = self.n_kv_heads * self.head_dim
            n += d * (q + 2 * kv) + q * d
            if b.cross_attn:
                n += d * (q + 2 * kv) + q * d
        elif b.kind == "rglru":
            w = self.rnn_width
            n += 2 * d * w  # in/gate projections
            n += w * self.conv1d_width  # temporal conv
            n += 2 * w * w + w  # lru gate projections + Lambda
            n += w * d  # out projection
        elif b.kind == "mlstm":
            w = self.rnn_width or d
            n += 2 * d * w  # up_proj (2w wide)
            n += w * self.conv1d_width
            n += 3 * w * w  # q, k, v
            n += 2 * w * self.n_heads  # i/f gates
            n += w * d  # down_proj
        elif b.kind == "slstm":
            w = self.rnn_width or d
            n += 4 * d * w  # in_proj (i,f,z,o)
            n += 4 * w * w // max(self.n_heads, 1)  # block-diag state mixing
            n += w * d  # out_proj
        if b.moe is not None:
            m = b.moe
            per_expert = 3 * d * m.d_ff_expert
            experts = m.top_k if active_only else m.num_experts
            n += experts * per_expert + d * m.num_experts
            if m.num_shared:
                n += 3 * d * m.d_ff_shared
        elif b.ffn != "none":
            mult = 3 if b.ffn in ("swiglu", "geglu") else 2
            n += mult * d * self.d_ff
        return n


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell: what gets lowered in the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
