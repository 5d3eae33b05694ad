"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each wrapper launches its kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors; each keeps a ``launches`` counter.
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.binning import counting_positions
from repro_torch.kernels.fused import cobra_bin_accumulate
from repro_torch.kernels.histogram import histogram

KERNELS = (histogram, counting_positions, cobra_bin_accumulate)


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper name."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "ops",
    "ref",
    "histogram",
    "counting_positions",
    "cobra_bin_accumulate",
    "launch_counts",
    "reset_launch_counts",
]
