"""Deterministic synthetic token pipeline (port of
``repro/data/pipeline.py``), in numpy: the batches equal the reference's
bit for bit.

The stream is a pure function of (seed, step), so a restart from
checkpoint step N reproduces the batches the lost run would have seen:
there is no loader state to checkpoint. ``host_index`` / ``host_count``
give each host ``global_batch // host_count`` rows; as in the reference,
every host draws the same rows (the index is recorded, not used).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.registry import ShapeSpec
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    host_index: int = 0
    host_count: int = 1
    # synthetic structure: orderful-ish streams so the LM loss can fall
    markov_order: int = 2


class SyntheticLM:
    """Markov-ish synthetic LM stream: every (k+1)-th token is a seeded hash
    of the token k before it, for k up to ``markov_order``."""

    def __init__(self, dc: DataConfig):
        if dc.global_batch % dc.host_count:
            raise ValueError(f"global batch {dc.global_batch} does not split over "
                             f"{dc.host_count} hosts")
        self.dc = dc
        self.local_batch = dc.global_batch // dc.host_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """int32 ``tokens`` and ``labels`` (B, S), labels the tokens shifted
        by one."""
        dc = self.dc
        rng = np.random.default_rng(
            np.uint64(dc.seed) + np.uint64(step) * np.uint64(1_000_003)
        )
        B, S = self.local_batch, dc.seq_len
        base = rng.integers(0, dc.vocab_size, size=(B, S + 1), dtype=np.int64)
        for k in range(1, dc.markov_order + 1):
            mask = (np.arange(S + 1) % (k + 1)) == 0
            shifted = np.roll(base, k, axis=1)
            base[:, mask] = (shifted[:, mask] * 2654435761 + k) % dc.vocab_size
        return {"tokens": base[:, :-1].astype(np.int32), "labels": base[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_data(cfg: ModelConfig, shape: ShapeSpec, seed: int = 1234,
              host_index: int = 0, host_count: int = 1) -> SyntheticLM:
    return SyntheticLM(DataConfig(
        seed=seed, vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, host_index=host_index, host_count=host_count,
    ))
