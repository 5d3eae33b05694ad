"""Core of the PyTorch port: graph, plan, PB, executor, Neighbor-Populate,
PageRank, connected components, traversal, radii, reordering,
preprocessing, graph mutation and sharded PB over ``torch.distributed``."""
from repro_torch.core.cobra import cobra_scatter_add, hierarchical_binning
from repro_torch.core.components import (
    connected_components,
    connected_components_fused,
    connected_components_incremental,
    connected_components_sharded,
)
from repro_torch.core.distributed_pb import (
    StreamMesh,
    make_stream_mesh,
    shard_build_csr,
    shard_reduce_stream,
)
from repro_torch.core.executor import (
    METHODS,
    REDUCE_METHODS,
    BatchedBins,
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
    TOMBSTONE,
    SlackCSR,
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
    build_csr_sharded,
    build_slack_csr,
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
    pagerank_sharded,
    pb_bin_edges,
)
from repro_torch.core.pb import Bins, binning, binning_counting, binning_sort
from repro_torch.core.plan import CobraPlan, HardwareModel, compromise_bin_range
from repro_torch.core.preprocess import (
    PreprocessPipeline,
    PreprocessReport,
    PreprocessResult,
    amortization_iters,
)
from repro_torch.core.radii import RadiiResult, radii
from repro_torch.core.reorder import (
    REORDER_VARIANTS,
    degree_sort_rebuild,
    relabel_coo,
    reorder_mapping,
    reorder_rebuild,
)
from repro_torch.core.traversal import (
    BATCHED_TRAVERSAL_METHODS,
    TRAVERSAL_METHODS,
    KCoreResult,
    PPRResult,
    TraversalResult,
    bfs,
    bfs_batched,
    bfs_incremental,
    k_core,
    k_core_oracle,
    personalized_pagerank,
    personalized_pagerank_oracle,
    sssp,
    sssp_batched,
)
from repro_torch.core.updates import (
    EdgeBatch,
    UpdateResult,
    apply_edge_batch,
    make_batch,
    merge_batch_coo,
    random_edge_batch,
    rebuild_slack_csr,
    touched_vertices,
)

__all__ = [
    "cobra_scatter_add", "hierarchical_binning",
    "connected_components", "connected_components_fused",
    "connected_components_incremental", "connected_components_sharded",
    "StreamMesh", "make_stream_mesh", "shard_build_csr", "shard_reduce_stream",
    "METHODS", "REDUCE_METHODS", "BatchedBins", "BinningDecision", "PBExecutor", "execute_binning",
    "execute_reduce", "get_default_executor", "set_default_executor",
    "COO", "CSR", "TOMBSTONE", "SlackCSR", "cached_graph", "degrees_from_coo", "gen_bubbles", "gen_kron",
    "gen_powerlaw", "gen_road", "gen_uniform", "graph_suite", "offsets_from_degrees",
    "segment_ids_from_offsets", "transpose_coo",
    "BUILD_METHODS", "build_csc", "build_csr", "build_csr_baseline", "build_csr_cobra",
    "build_csr_csc", "build_csr_oracle", "build_csr_pb", "build_csr_sharded", "build_slack_csr", "csr_equal_as_sets",
    "PRResult", "pagerank_coo_scatter", "pagerank_csr_pull", "pagerank_fused",
    "pagerank_incremental", "pagerank_pb", "pagerank_pb_prebinned", "pagerank_sharded",
    "pb_bin_edges",
    "Bins", "binning", "binning_counting", "binning_sort",
    "CobraPlan", "HardwareModel", "compromise_bin_range",
    "PreprocessPipeline", "PreprocessReport", "PreprocessResult", "amortization_iters",
    "RadiiResult", "radii",
    "REORDER_VARIANTS", "degree_sort_rebuild", "relabel_coo", "reorder_mapping",
    "reorder_rebuild",
    "BATCHED_TRAVERSAL_METHODS", "TRAVERSAL_METHODS", "KCoreResult", "PPRResult",
    "TraversalResult", "bfs", "bfs_batched", "bfs_incremental", "k_core", "k_core_oracle",
    "personalized_pagerank", "personalized_pagerank_oracle", "sssp", "sssp_batched",
    "EdgeBatch", "UpdateResult", "apply_edge_batch", "make_batch", "merge_batch_coo",
    "random_edge_batch", "rebuild_slack_csr", "touched_vertices",
]
