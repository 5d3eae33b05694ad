"""Start the ranks of a ``torch.distributed`` gloo group on this host.

The sharded paths (``core/distributed_pb.py``) are SPMD: every rank runs
the same entry point on the same global tensors. ``spawn_ranks`` starts
``world`` processes with the ``spawn`` method (safe in a parent that has
initialised CUDA), joins each to a gloo group through a ``FileStore`` in
a fresh file (no TCP port, so groups run side by side), runs
``fn(rank, world, *args)`` in each, and joins them with a deadline.
Given a sequence of sizes, one pool of ``max(worlds)`` processes runs a
group of each size in turn (ranks ``0..w-1``; the others wait for the
next), so the processes start and import ``torch`` once. On
one card every rank uses ``cuda:0``: NCCL refuses two ranks on one
device, and gloo takes CUDA tensors, staging them through host memory.

A rank that raises or exits with another code than 0 fails the call, and
ranks still running at the deadline are killed and fail it too, so a
collective that one rank never reaches cannot hang the caller. Each
rank runs ``torch`` on its share of the parent's cores. ``fn`` must be
importable by the children (a module-level function).
"""
from __future__ import annotations

import datetime
import os
import time
import uuid

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn, worlds: tuple, store_path: str, timeout_s: float, threads: int,
               args: tuple):
    # the ranks share the parent's cores: more intra-op threads than that
    # would spin against each other
    torch.set_num_threads(threads)
    for world in worlds:
        if rank >= world:
            continue
        store = dist.FileStore(f"{store_path}-w{world}", world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            fn(rank, world, *args)
        finally:
            dist.destroy_process_group()


def spawn_ranks(fn, world, *, store_dir: str, timeout: float, args: tuple = ()) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of one gloo
    group, or on a group of each size in the sequence ``world`` in turn,
    and wait for all of them, at most ``timeout`` seconds in all. Raises
    ``torch.multiprocessing.ProcessRaisedException`` (or
    ``ProcessExitedException``) when a rank fails, ``TimeoutError`` when
    the deadline passes; every rank has ended when it returns or raises."""
    worlds = (world,) if isinstance(world, int) else tuple(world)
    nprocs = max(worlds)
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, f"store-{uuid.uuid4().hex}")
    threads = max(1, len(os.sched_getaffinity(0)) // nprocs)
    ctx = mp.start_processes(
        _rank_main, args=(fn, worlds, store_path, float(timeout), threads, tuple(args)),
        nprocs=nprocs, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks of groups {worlds} did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        for w in worlds:
            try:
                os.remove(f"{store_path}-w{w}")
            except OSError:
                pass  # FileStore removes its file when the last rank leaves
