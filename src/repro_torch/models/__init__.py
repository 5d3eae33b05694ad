"""Models of the PyTorch port: GNN neighbour aggregation and one
message-passing layer (``gnn.py``, port of ``repro/models/layers.py:392-525``),
and the dense decoder-only LM (``config.py``, ``params.py``, ``layers.py``,
``transformer.py``)."""
from repro_torch.models.gnn import GNNLayer, gnn_aggregate

__all__ = ["GNNLayer", "gnn_aggregate"]
