"""Harness of ``test_torch_sharded.py`` and ``test_torch_sharded_pipeline.py``.

The reference runs in one subprocess per file with 8 forced host devices
(``--xla_force_host_platform_device_count=8``, the isolation rule of
``tests/test_sharded.py``: the pytest process keeps its one CPU device)
and saves its results to ``ref.npz``. The port runs in gloo groups of
spawned CPU ranks (``repro_torch.launch.ranks.spawn_ranks``: one pool of
8 processes runs the groups of 1, 2, 4 and 8 in turn, a FileStore under
the test's directory, no TCP port, a deadline on the join), each rank
saving its results to ``port_w<world>_r<rank>.npz``. Both sides read
their inputs from one ``inputs.npz`` the test writes from numpy seeds.
Info dicts and decision records travel as JSON strings.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4, 8)
RANK_TIMEOUT = 600  # seconds for the pool's spawn, every group's run, and the join

REF_PRELUDE = """
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
assert jax.device_count() == 8
inputs = dict(np.load("inputs.npz"))
out = {}
def save_json(key, obj):
    out[key] = np.asarray(json.dumps(obj, sort_keys=True, default=bool))
"""


def run_reference(body: str, workdir, timeout: int = 600) -> dict:
    """Run ``body`` (after ``REF_PRELUDE``) on 8 forced host devices in
    ``workdir``; it fills ``out``, which comes back as the loaded npz."""
    code = textwrap.dedent(REF_PRELUDE) + textwrap.dedent(body) + '\nnp.savez("ref.npz", **out)\n'
    env = dict(os.environ)
    # LLVM's costly passes take a quarter to a third of the reference's
    # time and change none of its integer results; its float results move
    # by one ulp at most (PageRank's ranks), far inside the tests' tolerances
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(workdir),
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-4000:]}"
    with np.load(os.path.join(str(workdir), "ref.npz")) as z:
        return {k: z[k] for k in z.files}


def save_rank(workdir, world: int, rank: int, out: dict) -> None:
    np.savez(os.path.join(str(workdir), f"port_w{world}_r{rank}.npz"), **out)


def as_json(obj) -> np.ndarray:
    return np.asarray(json.dumps(obj, sort_keys=True, default=bool))


def run_port(fn, workdir, worlds=WORLDS) -> dict:
    """Run ``fn(rank, world, workdir)`` on gloo groups of each size in
    ``worlds``; returns ``{world: rank 0's results}`` after checking that
    every rank returned the same arrays (each rank returns the whole
    result)."""
    from repro_torch.launch.ranks import spawn_ranks

    spawn_ranks(fn, worlds, store_dir=os.path.join(str(workdir), "store"),
                timeout=RANK_TIMEOUT, args=(str(workdir),))
    results = {}
    for w in worlds:
        ranks = []
        for r in range(w):
            with np.load(os.path.join(str(workdir), f"port_w{w}_r{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
        for r, got in enumerate(ranks[1:], start=1):
            assert got.keys() == ranks[0].keys(), (w, r)
            for k in got:
                np.testing.assert_array_equal(got[k], ranks[0][k],
                                              err_msg=f"world {w} rank {r} {k}")
        results[w] = ranks[0]
    return results


def loads(a: np.ndarray):
    return json.loads(str(a))
