"""olmoe-1b-7b [arXiv:2409.02060; hf] — MoE, 64 experts top-8, QK-norm.
16L d_model=2048 16H (kv=16) d_ff=1024(expert) vocab=50304."""
import torch

from ..models.transformer import TransformerConfig
from ..nn.moe import MoESettings
from .base import ArchSpec, FULL_ATTENTION_SKIP, LM_SHAPES, register


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-1b-7b",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1024,
        vocab=50304,
        qk_norm=True,
        moe=MoESettings(n_experts=64, top_k=8, d_ff=1024, every=1),
        tie_embeddings=False,
        dtype=torch.bfloat16,
        remat="dots",
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-1b-7b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=64,
        vocab=512,
        qk_norm=True,
        moe=MoESettings(n_experts=8, top_k=2, d_ff=64, every=1),
        tie_embeddings=False,
        dtype=torch.float32,
        remat="none",
        attn_chunk=64,
    )


register(
    ArchSpec(
        arch_id="olmoe-1b-7b",
        family="lm",
        source="arXiv:2409.02060; hf",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=LM_SHAPES,
        skips={"long_500k": FULL_ATTENTION_SKIP},
    )
)
