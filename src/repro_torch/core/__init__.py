"""Core of the PyTorch port: the slice's graph, plan, PB, executor,
Neighbor-Populate and PageRank modules."""
from repro_torch.core.cobra import cobra_scatter_add, hierarchical_binning
from repro_torch.core.executor import (
    METHODS,
    REDUCE_METHODS,
    BinningDecision,
    PBExecutor,
    execute_binning,
    execute_reduce,
    get_default_executor,
    set_default_executor,
)
from repro_torch.core.graph import (
    COO,
    CSR,
    cached_graph,
    degrees_from_coo,
    gen_bubbles,
    gen_kron,
    gen_powerlaw,
    gen_road,
    gen_uniform,
    graph_suite,
    offsets_from_degrees,
    segment_ids_from_offsets,
    transpose_coo,
)
from repro_torch.core.neighbor_populate import (
    BUILD_METHODS,
    build_csc,
    build_csr,
    build_csr_baseline,
    build_csr_cobra,
    build_csr_csc,
    build_csr_oracle,
    build_csr_pb,
    csr_equal_as_sets,
)
from repro_torch.core.pagerank import (
    PRResult,
    pagerank_coo_scatter,
    pagerank_csr_pull,
    pagerank_fused,
    pagerank_incremental,
    pagerank_pb,
    pagerank_pb_prebinned,
    pb_bin_edges,
)
from repro_torch.core.pb import Bins, binning, binning_counting, binning_sort
from repro_torch.core.plan import CobraPlan, HardwareModel, compromise_bin_range

__all__ = [
    "cobra_scatter_add", "hierarchical_binning",
    "METHODS", "REDUCE_METHODS", "BinningDecision", "PBExecutor", "execute_binning",
    "execute_reduce", "get_default_executor", "set_default_executor",
    "COO", "CSR", "cached_graph", "degrees_from_coo", "gen_bubbles", "gen_kron",
    "gen_powerlaw", "gen_road", "gen_uniform", "graph_suite", "offsets_from_degrees",
    "segment_ids_from_offsets", "transpose_coo",
    "BUILD_METHODS", "build_csc", "build_csr", "build_csr_baseline", "build_csr_cobra",
    "build_csr_csc", "build_csr_oracle", "build_csr_pb", "csr_equal_as_sets",
    "PRResult", "pagerank_coo_scatter", "pagerank_csr_pull", "pagerank_fused",
    "pagerank_incremental", "pagerank_pb", "pagerank_pb_prebinned", "pb_bin_edges",
    "Bins", "binning", "binning_counting", "binning_sort",
    "CobraPlan", "HardwareModel", "compromise_bin_range",
]
