"""equiformer-v2 [arXiv:2306.12059; unverified] — n_layers=12 d_hidden=128
l_max=6 m_max=2 n_heads=8, SO(2)-eSCN equivariant graph attention."""
from ..models.gnn.equiformer_v2 import EquiformerV2Config
from .base import ArchSpec, GNN_SHAPES, register


def full_config() -> EquiformerV2Config:
    return EquiformerV2Config(
        n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8
    )


def smoke_config() -> EquiformerV2Config:
    return EquiformerV2Config(
        n_layers=2, d_hidden=8, l_max=3, m_max=2, n_heads=2, n_rbf=8,
        n_species=8,
    )


register(
    ArchSpec(
        arch_id="equiformer-v2",
        family="gnn",
        source="arXiv:2306.12059; unverified",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=GNN_SHAPES,
        skips={},
        notes="eSCN trick: O(L^6) tensor product -> O(L^3) SO(2) conv in the "
        "edge-aligned Wigner frame (irreps.align_matrices)",
    )
)
