"""Per-architecture configs (one module per architecture) and the registry."""
from repro_torch.configs.registry import SHAPES, get_config, list_archs

__all__ = ["SHAPES", "get_config", "list_archs"]
