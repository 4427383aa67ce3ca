"""pna [arXiv:2004.05718; paper] — n_layers=4 d_hidden=75,
aggregators mean-max-min-std, scalers id-amp-atten."""
from ..models.gnn.pna import PNAConfig
from .base import ArchSpec, GNN_SHAPES, register


def full_config() -> PNAConfig:
    return PNAConfig(n_layers=4, d_hidden=75, d_feat=1433, n_out=40)


def smoke_config() -> PNAConfig:
    return PNAConfig(n_layers=2, d_hidden=12, d_feat=16, n_out=4)


register(
    ArchSpec(
        arch_id="pna",
        family="gnn",
        source="arXiv:2004.05718; paper",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=GNN_SHAPES,
        skips={},
        notes="SpMM/segment-reduce regime; 4 aggregators x 3 degree scalers",
    )
)
