"""minicpm-2b [arXiv:2404.06395; hf] — llama-like with WSD schedule + mup-style
scaling. 40L d_model=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753.
scale_emb=12, scale_depth=1.4 (residual scale 1.4/sqrt(40)),
logit scale dim_model_base/d_model = 256/2304."""
import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, FULL_ATTENTION_SKIP, LM_SHAPES, register


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm-2b",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        d_head=64,
        d_ff=5760,
        vocab=122753,
        emb_scale=12.0,
        residual_scale=1.4 / (40 ** 0.5),
        logit_scale=256.0 / 2304.0,
        tie_embeddings=True,
        dtype=torch.bfloat16,
        remat="dots",
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm-2b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab=515,  # deliberately non-multiple of 256: tests vocab padding
        emb_scale=12.0,
        residual_scale=1.4 / (2 ** 0.5),
        logit_scale=0.5,
        dtype=torch.float32,
        remat="none",
        attn_chunk=64,
    )


register(
    ArchSpec(
        arch_id="minicpm-2b",
        family="lm",
        source="arXiv:2404.06395; hf",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=LM_SHAPES,
        skips={"long_500k": FULL_ATTENTION_SKIP},
        schedule="wsd",
        notes="WSD schedule (optim/schedules.wsd_schedule)",
    )
)
