"""Bin-range planning (port of ``repro/core/plan.py``).

The planning arithmetic is copied unchanged, so that the same
``HardwareModel`` fields give the same ``CobraPlan`` in both packages.
What the port adds is ``HardwareModel.h100()``, its default model:

  * ``fast_levels = (232_448, 50 * 2**20)`` — shared memory one block may
    opt into on an H100 SXM, then the 50 MB L2;
  * ``cbuffer_bytes = 128`` — one L2 line, the unit of a coalesced write;
  * ``dram_bandwidth = 3.35e12`` — HBM3 on the SXM part;
  * ``fast_bandwidth`` — shared-memory bandwidth summed over the card:
    132 SMs x 128 bytes per clock (32 banks x 4 bytes) x 1.98 GHz boost
    clock = 33.45e12 bytes/s.

(NVIDIA's H100 data sheet and Hopper white paper.) The fields are
constants, never read from the device at run time, so a CPU test and
the card make the same plans; ``chip_smoke.py`` prints the device's own
properties beside them so that a mismatch is visible.

The H100 model also carries what the executor's fit rule for flat fused
reductions reads (``PBExecutor.fused_fits``): the two-pass fused kernel
(``kernels/fused.py``) reduces each slab of the output in shared memory,
so its output need not be resident in any fast level. It takes up to
``fused_max_indices`` = 2048 slabs of 32768 indices
(``TWO_PASS_MAX_INDICES``) and ``fused_scratch_per_tuple`` = 6 bytes of
scratch a tuple (a 16-bit offset and the 4-byte value), which must fit
``device_memory`` (80 GB on the SXM part). The reference's models leave
these fields at 0, which keeps the reference's rule.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple


# The H100 SXM's peaks, the defaults of the port's rooflines
# (repro_torch/roofline.py) and of the sharded cost terms (core/traffic.py):
# NVIDIA's data sheet, dense rates, at the 700 W power limit.
H100_BF16_FLOPS = 989e12  # bf16 tensor-core FLOP/s, dense
H100_HBM_BW = 3.35e12  # HBM3 bytes/s (the h100() model's dram_bandwidth)
H100_NVLINK_BW = 900e9  # NVLink bytes/s a card sends and receives together (450 each way)


@dataclass(frozen=True)
class HardwareModel:
    """Capacities that bound C-Buffer fan-out per level (bytes, bytes/s)."""

    name: str
    fast_levels: Sequence[int]  # capacity of each fast level, small -> large
    cbuffer_bytes: int
    dram_bandwidth: float
    fast_bandwidth: float
    # flat fused reductions that need no resident accumulator (0: none)
    fused_max_indices: int = 0
    fused_scratch_per_tuple: int = 0
    device_memory: int = 0

    @staticmethod
    def cpu_xeon() -> "HardwareModel":
        return HardwareModel(
            name="xeon-14c",
            fast_levels=(32 * 1024, 1024 * 1024, 35 * 1024 * 1024),
            cbuffer_bytes=64,
            dram_bandwidth=60e9,
            fast_bandwidth=1000e9,
        )

    @staticmethod
    def tpu_v5e() -> "HardwareModel":
        return HardwareModel(
            name="tpu-v5e",
            fast_levels=(64 * 1024 * 1024,),
            cbuffer_bytes=8 * 128 * 4,
            dram_bandwidth=819e9,
            fast_bandwidth=20e12,
        )

    @staticmethod
    def h100() -> "HardwareModel":
        return HardwareModel(
            name="h100-sxm",
            fast_levels=(232_448, 50 * 2**20),
            cbuffer_bytes=128,
            dram_bandwidth=H100_HBM_BW,
            fast_bandwidth=132 * 128 * 1.98e9,
            fused_max_indices=32768 * 2048,
            fused_scratch_per_tuple=6,
            device_memory=80 * 10**9,
        )


TUPLE_BYTES = 8  # (index, value) int32 pairs, as in the paper


def fused_fits(
    hw: HardwareModel, num_indices: int, value_bytes: int = 4, stream_len: int = 0,
    flat: bool = True,
) -> bool:
    """Fusion legality, capacity half (``PBExecutor.fused_fits``): the
    reference's rule, a dense accumulator of ``num_indices * value_bytes``
    within half the largest fast level; a model with ``fused_max_indices``
    also admits a flat stream of 4-byte values that its two-pass kernel
    takes, limited by that index bound and by ``fused_scratch_per_tuple``
    bytes of scratch a tuple within ``device_memory``."""
    if num_indices * value_bytes <= hw.fast_levels[-1] // 2:
        return True
    return bool(
        flat
        and value_bytes == 4
        and 0 < num_indices <= hw.fused_max_indices
        and stream_len * hw.fused_scratch_per_tuple <= hw.device_memory
    )


def num_bins_for_range(num_indices: int, bin_range: int) -> int:
    return max(1, math.ceil(num_indices / bin_range))


def binread_optimal_range(hw: HardwareModel, value_bytes_per_index: int = 8) -> int:
    """Bin-Read wants each bin's index range resident in the innermost
    fast level."""
    return max(1, hw.fast_levels[0] // (2 * value_bytes_per_index))


def binning_optimal_num_bins(hw: HardwareModel) -> int:
    """Binning wants all C-Buffers resident in the innermost fast level."""
    return max(2, hw.fast_levels[0] // (2 * hw.cbuffer_bytes))


def compromise_bin_range(num_indices: int, hw: HardwareModel) -> int:
    """The single-knob software-PB compromise: geometric mean of the two
    phases' optima."""
    r_read = binread_optimal_range(hw)
    r_bin = max(1, math.ceil(num_indices / binning_optimal_num_bins(hw)))
    return int(max(1, math.sqrt(r_read * r_bin)))


@dataclass(frozen=True)
class CobraPlan:
    """A knob-free hierarchical binning plan: ``level_fanouts[k]`` child
    bins per level-k bin on pass k; the final range is Bin-Read-optimal."""

    num_indices: int
    final_bin_range: int
    level_fanouts: Tuple[int, ...] = ()

    @property
    def num_bins(self) -> int:
        return num_bins_for_range(self.num_indices, self.final_bin_range)

    @property
    def num_passes(self) -> int:
        return len(self.level_fanouts)

    def level_ranges(self) -> List[int]:
        """Bin range after each pass (coarse -> fine), nested multiples of
        the final range."""
        ranges = []
        for k in range(len(self.level_fanouts)):
            mult = 1
            for y in self.level_fanouts[k + 1 :]:
                mult *= y
            ranges.append(self.final_bin_range * mult)
        return ranges

    @staticmethod
    def from_hardware(
        num_indices: int,
        hw: HardwareModel | None = None,
        value_bytes_per_index: int = 8,
        max_fanout: int | None = None,
        final_bin_range: int | None = None,
    ) -> "CobraPlan":
        """Derive the knob-free plan; ``hw=None`` is the H100 model."""
        hw = hw or HardwareModel.h100()
        final_range = final_bin_range or min(
            binread_optimal_range(hw, value_bytes_per_index), num_indices
        )
        final_range = max(1, min(final_range, num_indices))
        total_bins = num_bins_for_range(num_indices, final_range)
        per_pass = max_fanout or binning_optimal_num_bins(hw)
        fanouts: List[int] = []
        remaining = total_bins
        while remaining > 1:
            y = min(per_pass, remaining)
            fanouts.append(y)
            remaining = math.ceil(remaining / y)
        if not fanouts:
            fanouts = [1]
        return CobraPlan(
            num_indices=num_indices,
            final_bin_range=final_range,
            level_fanouts=tuple(fanouts),
        )
