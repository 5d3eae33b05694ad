"""Static analysis and runtime contracts for the port (port of
``repro/analysis``).

  ``repro_torch.analysis.lint``       — the AST linter (stdlib ``ast``):
      rules PB001, PB002, PB004-PB007, pragmas, a baseline. CLI:
      ``python -m repro_torch.analysis.lint``.
  ``repro_torch.analysis.contracts``  — the runtime stream contract:
      ``check_stream`` runs inside ``PBExecutor.reduce_stream`` and
      ``shard_reduce_stream`` on every call; ``REPRO_PB_CHECK=1`` turns on
      the checks that read the indices.

This ``__init__`` imports nothing: the linter must not load ``torch``
or the executor (``contracts`` does), so both names resolve lazily.
"""
from __future__ import annotations

__all__ = ["lint", "contracts"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"repro_torch.analysis.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
