"""Serving of the PyTorch port: the continuous-batching LM ``Engine``, the
multi-tenant ``GraphFrontend`` and their clocks."""
from repro_torch.serving.graph_frontend import (
    QUERY_KINDS,
    Clock,
    FakeClock,
    GraphFrontend,
    GraphQuery,
    RegisteredGraph,
    TraceReport,
    WarmupReport,
    latency_stats,
    percentile,
    poisson_trace,
    replay_trace,
)
from repro_torch.serving.server import Engine, Request

__all__ = [
    "QUERY_KINDS", "Clock", "FakeClock", "GraphFrontend", "GraphQuery", "RegisteredGraph",
    "TraceReport", "WarmupReport", "latency_stats", "percentile", "poisson_trace",
    "replay_trace", "Engine", "Request",
]
