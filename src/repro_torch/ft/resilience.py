"""Fault tolerance of the training loop (port of ``repro/ft/resilience.py``),
in pure Python; all three pieces are host-side.

  StragglerDetector: per-host step-time EWMA and a robust z-score against
    the fleet median; a host slower than the threshold for ``patience``
    consecutive steps is flagged.

  Heartbeat: a watchdog thread; if the loop does not beat within
    ``timeout_s`` (a hung collective, a dead host) the callback fires.

  ElasticPlan: given the surviving device count, the largest
    (data, model) mesh that keeps the model axis, and the gradient
    accumulation that keeps the global batch. A checkpoint saved on the old
    mesh restores onto the new one (``CheckpointManager.restore(mesh=,
    specs=)``), and ``make_train_step(accum_steps=, mesh=)`` continues
    there.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class StragglerDetector:
    def __init__(self, alpha: float = 0.05, threshold: float = 2.0, patience: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.mean: Dict[str, float] = {}
        self.var: Dict[str, float] = {}
        self.strikes: Dict[str, int] = {}

    def observe(self, host: str, step_time: float) -> bool:
        """Returns True if this host is currently flagged as a straggler."""
        m = self.mean.get(host, step_time)
        v = self.var.get(host, 0.0)
        d = step_time - m
        m += self.alpha * d
        v = (1 - self.alpha) * (v + self.alpha * d * d)
        self.mean[host], self.var[host] = m, v
        # compare to fleet median
        fleet = sorted(self.mean.values())
        med = fleet[len(fleet) // 2]
        sd = max(v**0.5, 1e-6, 0.05 * med)
        is_slow = step_time > med + self.threshold * sd and step_time > 1.2 * med
        self.strikes[host] = self.strikes.get(host, 0) + 1 if is_slow else 0
        return self.strikes[host] >= self.patience

    def flagged(self) -> List[str]:
        return [h for h, s in self.strikes.items() if s >= self.patience]


class Heartbeat:
    def __init__(self, timeout_s: float, on_timeout: Optional[Callable] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout or (lambda: None)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    @property
    def fired(self) -> bool:
        return self._fired

    def _watch(self):
        while not self._stop.wait(min(self.timeout_s / 4, 1.0)):
            if time.monotonic() - self._last > self.timeout_s:
                self._fired = True
                self.on_timeout()
                return


@dataclass
class ElasticPlan:
    """Re-mesh plan after losing devices."""

    old_data: int
    old_model: int
    surviving_devices: int
    new_data: int = field(init=False)
    new_model: int = field(init=False)
    batch_scale: float = field(init=False)

    def __post_init__(self):
        self.new_model = self.old_model  # TP degree pinned by memory
        self.new_data = self.surviving_devices // self.new_model
        if self.new_data < 1:
            raise RuntimeError(
                f"cannot keep TP={self.old_model} with {self.surviving_devices} devices"
            )
        # keep global batch via grad accumulation: scale accum steps
        self.batch_scale = self.old_data / self.new_data

    def mesh_shape(self):
        return (self.new_data, self.new_model)

    def accumulation_steps(self, old_accum: int = 1) -> int:
        import math

        return max(1, math.ceil(old_accum * self.batch_scale))
