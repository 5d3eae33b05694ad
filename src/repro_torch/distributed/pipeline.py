"""GPipe pipeline parallelism over a ``pipe`` mesh axis (port of
``repro/distributed/pipeline.py``), forward only, as in the reference.

Each stage rank holds its own slice of the stage parameters; M
microbatches stream through the P stages in M + P - 1 ticks. At tick t
stage s works on microbatch t - s when that is one (stage 0 reads it
from the input), and sends its output one hop on with
``batch_isend_irecv``, which stage s + 1 receives for tick t + 1. The
last stage's outputs, microbatch m at tick m + P - 1, are broadcast to
every stage, as the reference's ``psum`` of the last stage's outputs
replicates them. The reference also runs every stage on its bubble
ticks (on a clipped microbatch or a zero carry) and drops what they make;
the port skips those ticks. Bubble fraction (P - 1) / (M + P - 1).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def gpipe_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor, mesh,
                axis: str = "pipe") -> torch.Tensor:
    """``y = stage_{P-1}(...stage_0(x))`` for each microbatch of
    ``microbatches`` (M, mb, ...), every rank passing the same input and
    its stage's ``stage_params`` (the stage's index is its coordinate on
    ``axis``). ``stage_fn(params, x)`` keeps the shape. Returns the (M,
    mb, ...) outputs on every rank."""
    P = mesh.shape[axis]
    M = microbatches.shape[0]
    s = mesh.axis_index(axis)
    group = mesh.group(axis)
    if group is None:
        return torch.stack([stage_fn(stage_params, x) for x in microbatches])
    ranks = dist.get_process_group_ranks(group)  # the stages in order
    # gloo sends and receives host tensors only: stage a card's through them
    host = dist.get_backend(group) == "gloo" and microbatches.device.type != "cpu"
    buf_dev = torch.device("cpu") if host else microbatches.device
    outs = torch.empty_like(microbatches)
    h = None
    for t in range(M + P - 1):
        ops = []
        m = t - s
        if 0 <= m < M:
            y = stage_fn(stage_params, microbatches[m] if s == 0 else h)
            if s == P - 1:
                outs[m] = y
            else:
                ops.append(dist.P2POp(dist.isend, y.to(buf_dev).contiguous(), ranks[s + 1],
                                      group))
        recv = None
        if s > 0 and 0 <= t - (s - 1) < M:  # stage s - 1 works on microbatch t - s + 1 now
            recv = torch.empty(microbatches.shape[1:], dtype=microbatches.dtype, device=buf_dev)
            ops.append(dist.P2POp(dist.irecv, recv, ranks[s - 1], group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if recv is not None:
            h = recv.to(microbatches.device)
    dist.broadcast(outs, ranks[P - 1], group=group)
    return outs


def bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
