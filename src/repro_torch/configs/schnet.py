"""schnet [arXiv:1706.08566; paper] — n_interactions=3 d_hidden=64 rbf=300
cutoff=10."""
from ..models.gnn.schnet import SchNetConfig
from .base import ArchSpec, GNN_SHAPES, register


def full_config() -> SchNetConfig:
    return SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)


def smoke_config() -> SchNetConfig:
    return SchNetConfig(
        n_interactions=2, d_hidden=8, n_rbf=16, cutoff=10.0, n_species=8
    )


register(
    ArchSpec(
        arch_id="schnet",
        family="gnn",
        source="arXiv:1706.08566; paper",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=GNN_SHAPES,
        skips={},
        notes="triplet-free continuous-filter conv (gather + segment_sum)",
    )
)
