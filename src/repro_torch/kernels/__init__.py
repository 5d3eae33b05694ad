"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each wrapper launches its kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors; each keeps a ``launches`` counter.
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.binning import cobra_binning_pass, counting_positions
from repro_torch.kernels.binread import binread_scatter_add
from repro_torch.kernels.flashattn import flash_attention
from repro_torch.kernels.fused import cobra_bin_accumulate, cobra_bin_accumulate_rows
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.scatter_rows import scatter_rows

KERNELS = (
    histogram,
    counting_positions,
    cobra_binning_pass,
    cobra_bin_accumulate,
    cobra_bin_accumulate_rows,
    binread_scatter_add,
    scatter_rows,
    flash_attention,
)


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper name."""
    return {k.__name__: k.launches for k in KERNELS}


def launch_shapes() -> dict:
    """Kernel launches so far, by wrapper name and then by shape (each
    wrapper's own key, e.g. ``(m, num_bins)``), as ``{"m,B": count}``."""
    return {k.__name__: {",".join(map(str, s)): c for s, c in k.shapes.items()} for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches, k.shapes = 0, {}


__all__ = [
    "ops",
    "ref",
    "histogram",
    "counting_positions",
    "cobra_binning_pass",
    "cobra_bin_accumulate",
    "cobra_bin_accumulate_rows",
    "binread_scatter_add",
    "scatter_rows",
    "flash_attention",
    "KERNELS",
    "launch_counts",
    "launch_shapes",
    "reset_launch_counts",
]
