"""llama4-maverick-400b-a17b [hf:meta-llama; unverified] — MoE 128e top-1,
interleaved MoE (every 2nd layer), iRoPE attention (3 chunked-local layers +
1 NoPE global per period, chunk 8192), shared expert.
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.

long_500k RUNS: chunked-local layers keep O(chunk) KV; only the 12 global
layers carry the full 500k cache."""
import torch

from ..models.transformer import TransformerConfig
from ..nn.moe import MoESettings
from .base import ArchSpec, LM_SHAPES, register


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama4-maverick-400b-a17b",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab=202048,
        rope_theta=5e5,
        layer_pattern=("chunk", "chunk", "chunk", "global_nope"),
        window=8192,
        moe=MoESettings(
            n_experts=128, top_k=1, d_ff=8192, n_shared=1, every=2
        ),
        tie_embeddings=False,
        dtype=torch.bfloat16,
        remat="dots",
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama4-maverick-smoke",
        n_layers=4,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=128,
        vocab=512,
        layer_pattern=("chunk", "chunk", "chunk", "global_nope"),
        window=32,
        moe=MoESettings(n_experts=8, top_k=1, d_ff=128, n_shared=1, every=2),
        tie_embeddings=False,
        dtype=torch.float32,
        remat="none",
        attn_chunk=64,
    )


register(
    ArchSpec(
        arch_id="llama4-maverick-400b-a17b",
        family="lm",
        source="hf:meta-llama/Llama-4 family; unverified",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=LM_SHAPES,
        skips={},
        notes="hybrid chunked/global attention -> long_500k supported; "
        "early-fusion VLM frontend is out of scope ([moe] backbone only)",
    )
)
