"""Models of the PyTorch port: GNN neighbour aggregation and one
message-passing layer (port of ``repro/models/layers.py:392-525``)."""
from repro_torch.models.gnn import GNNLayer, gnn_aggregate

__all__ = ["GNNLayer", "gnn_aggregate"]
