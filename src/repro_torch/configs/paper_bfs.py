"""The paper's own engine as an arch: recursive query execution cells (port
of ``repro.configs.paper_bfs``, verbatim).

Four cells, one per paper dataset (Table 2) at its FULL published scale:
``launch.steps.build_cell`` makes the nTkS/nTkMS engine's decisions for
each on a mesh, ``launch.dryrun`` records them (and runs a cell on one
card over a seeded graph of the dataset's published node count and
degree law).
"""
import dataclasses

from .base import ArchSpec, ShapeSpec, register


@dataclasses.dataclass(frozen=True)
class PaperEngineConfig:
    name: str = "paper-bfs-engine"
    policy: str = "ntkms"  # recommended robust hybrid (+ lanes when >=64 srcs)
    edge_compute: str = "msbfs_lengths"
    n_sources: int = 64
    max_deg_cap: int = 64  # ELL truncation cap for the dry-run layout
    max_iters: int = 32
    or_impl: str = "ring"


def full_config() -> PaperEngineConfig:
    return PaperEngineConfig()


def smoke_config() -> PaperEngineConfig:
    return PaperEngineConfig(n_sources=8, max_deg_cap=16, max_iters=8,
                             policy="ntks", edge_compute="sp_lengths")


PAPER_SHAPES = (
    ShapeSpec("ldbc100", "query", dict(n_nodes=448_626, n_edges=19_941_198,
                                       avg_degree=44)),
    ShapeSpec("livejournal", "query", dict(n_nodes=4_847_571,
                                           n_edges=68_993_773, avg_degree=14)),
    ShapeSpec("spotify", "query", dict(n_nodes=3_604_454,
                                       n_edges=1_927_482_013, avg_degree=535)),
    ShapeSpec("graph500_28", "query", dict(n_nodes=121_242_388,
                                           n_edges=4_236_163_958,
                                           avg_degree=35)),
)


register(
    ArchSpec(
        arch_id="paper-bfs-engine",
        family="paper",
        source="this paper (PVLDB 18(11) 2025)",
        full_config=full_config,
        smoke_config=smoke_config,
        shapes=PAPER_SHAPES,
        skips={},
        notes="morsel policies as mesh programs; Table 2 datasets at full "
        "scale as dry-run cells",
    )
)
