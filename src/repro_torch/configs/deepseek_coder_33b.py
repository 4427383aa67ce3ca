"""deepseek-coder-33b [arXiv:2401.14196; hf] — dense llama-arch.
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256."""
import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, FULL_ATTENTION_SKIP, LM_SHAPES, register


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-coder-33b",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_head=128,
        d_ff=19200,
        vocab=32256,
        rope_theta=1e5,
        tie_embeddings=False,
        dtype=torch.bfloat16,
        remat="dots",
        norm_eps=1e-6,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-coder-33b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=128,
        vocab=512,
        tie_embeddings=False,
        dtype=torch.float32,
        remat="none",
        attn_chunk=64,
    )


register(
    ArchSpec(
        arch_id="deepseek-coder-33b",
        family="lm",
        source="arXiv:2401.14196; hf",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=LM_SHAPES,
        skips={"long_500k": FULL_ATTENTION_SKIP},
    )
)
