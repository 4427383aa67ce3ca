"""gemma2-2b [arXiv:2408.00118; hf] — local+global alternating, logit softcap.
26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256,
sliding window 4096, attn softcap 50, final softcap 30, sandwich norms.

long_500k RUNS for this arch: sliding-window layers keep O(window) KV; only
the 13 global layers carry full 500k caches (sharded over data+model)."""
import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, LM_SHAPES, register


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-2b",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_head=256,
        d_ff=9216,
        vocab=256000,
        layer_pattern=("local", "global"),
        window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        use_post_norm=True,
        zero_centered_norm=True,
        emb_scale=2304 ** 0.5,
        tie_embeddings=True,
        dtype=torch.bfloat16,
        remat="dots",
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-2b-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=512,
        layer_pattern=("local", "global"),
        window=32,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        use_post_norm=True,
        zero_centered_norm=True,
        emb_scale=8.0,
        dtype=torch.float32,
        remat="none",
        attn_chunk=64,
    )


register(
    ArchSpec(
        arch_id="gemma2-2b",
        family="lm",
        source="arXiv:2408.00118; hf",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=LM_SHAPES,
        skips={},
        notes="hybrid local/global attention -> long_500k supported",
    )
)
