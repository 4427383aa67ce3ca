"""dcn-v2 [arXiv:2008.13535; paper] — n_dense=13 n_sparse=26 embed_dim=16
n_cross_layers=3 mlp=1024-1024-512 interaction=cross (port of
``repro.configs.dcn_v2``).

The full config's fused table holds ``sum(CRITEO_VOCABS)`` = 35,900,000
rows of 16 float32: 2.30 GB."""
from ..models.dcn_v2 import DCNv2Config
from .base import ArchSpec, RECSYS_SHAPES, register


def full_config() -> DCNv2Config:
    return DCNv2Config()


def smoke_config() -> DCNv2Config:
    return DCNv2Config(
        mlp=(32, 32, 16),
        field_vocabs=tuple([97] * 26),
        embed_dim=8,
        retrieval_dim=8,
    )


register(
    ArchSpec(
        arch_id="dcn-v2",
        family="recsys",
        source="arXiv:2008.13535; paper",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=RECSYS_SHAPES,
        skips={},
        notes="fused-table EmbeddingBag (index_select + index_add); "
        "retrieval = batched dot + top_k",
    )
)
