"""Architecture registry and input-shape matrix (port of
``repro/configs/registry.py``).

Every architecture of the reference is registered here with the same
values, so ``get_config(name)`` equals the reference's field by field.
The port's model runs the dense family; ``get_config`` of another family
still returns its config, and ``models.transformer`` raises for it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # the per-arch modules register themselves when imported
        from repro_torch.configs import all_archs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    from repro_torch.configs import all_archs  # noqa: F401

    return sorted(_REGISTRY)


def cells(include_skipped: bool = False) -> List[Tuple[str, str, Optional[str]]]:
    """All (arch, shape, skip_reason) cells; ``skip_reason`` None: runnable."""
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        for sname, sp in SHAPES.items():
            reason = None
            if sp.name == "long_500k" and not cfg.supports_long_context:
                reason = "full quadratic attention at 512k is intractable (per spec: skip for pure full-attention archs; see DESIGN.md)"
            if sp.kind == "decode" and not cfg.is_decoder:
                reason = "encoder-only architecture has no decode step"
            if include_skipped or reason is None:
                out.append((arch, sname, reason))
    return out
