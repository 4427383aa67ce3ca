"""Paper core on a mesh of ranks (or one device): IFE engine, extension
backends, policies, collectives."""
from .edge_compute import EDGE_COMPUTES, NO_PARENT, QUERY_KINDS, QueryKind
from .edge_compute import chunk_fold
from .ife import (
    IFEResult,
    histogram_lengths,
    reconstruct_paths,
    run_ife,
    run_ife_batch,
    run_ife_scan,
    validate_parents,
)
from .policies import (
    POLICIES,
    BudgetMispredicts,
    BudgetModel,
    DirectionThresholds,
    MorselPolicy,
    count_budget_mispredicts,
    degree_bucket,
    fit_direction_thresholds,
    hybrid_phases,
    policy_1t1s,
    policy_nt1s,
    policy_ntkms,
    policy_ntks,
    pow2ceil,
    recommend_backend,
    recommend_k,
    recommend_policy,
)
from .extend import (
    BACKENDS,
    STATS_WIDTH,
    BackendCostProbe,
    ExtendSpec,
    GraphOperands,
    as_spec,
    build_operands,
    effective_csr,
    frontier_stats,
    OperandStream,
    make_backend,
    operand_stream,
    operands_from_numpy,
)
from .dispatcher import (
    QueryEngine,
    build_engine,
    build_gang_resume_engine,
    build_resume_engine,
    pad_sources,
    prepare_graph,
    run_recursive_query,
    strip_operands,
)
from .collectives import gang_handoff, gang_scatter_back
from .msbfs import gang_pack_lanes, gang_unpack_lanes
