"""Timing helpers (counterpart of ``benchmarks/common.py::time_fn``).

PyTorch returns before the card finishes, so a host timer without a wait
measures only the launch. ``time_fn`` synchronises CUDA after every call
(the reference waits with ``jax.block_until_ready``); ``cuda_ms`` times a
run of launches between CUDA events.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, reps: int = 5, warmup: int = 2) -> float:
    """Median wall-clock seconds of ``fn(*args)``, each call ending in a
    CUDA synchronise."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def cuda_ms(fn: Callable, *args, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn(*args)`` on the current CUDA
    stream, from CUDA events around ``reps`` back-to-back calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms measures the card; CUDA is not available")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
