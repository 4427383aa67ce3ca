"""mace [arXiv:2206.07697; paper] — n_layers=2 d_hidden=128 l_max=2
correlation_order=3 n_rbf=8, E(3)-ACE equivariance."""
from ..models.gnn.mace import MACEConfig
from .base import ArchSpec, GNN_SHAPES, register


def full_config() -> MACEConfig:
    return MACEConfig(
        n_layers=2, d_hidden=128, l_max=2, correlation_order=3, n_rbf=8
    )


def smoke_config() -> MACEConfig:
    return MACEConfig(
        n_layers=2, d_hidden=8, l_max=2, correlation_order=3, n_rbf=4,
        n_species=8,
    )


register(
    ArchSpec(
        arch_id="mace",
        family="gnn",
        source="arXiv:2206.07697; paper",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=GNN_SHAPES,
        skips={},
        notes="irrep tensor-product regime (kernel taxonomy §GNN); "
        "Gaunt contraction implements the ACE product basis",
    )
)
