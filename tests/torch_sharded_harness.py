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


# the LM tests' reference prelude: Auto-axis (data, model) meshes on the
# forced devices, and ``flat`` to save a tree's leaves under "prefix/path"
REF_LM = """
from jax.sharding import AxisType

def mesh(tag):
    shape = tuple(int(x) for x in tag.split("x"))
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])

def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf, np.float32)
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


# -- the LM meshes' helpers (test_torch_mesh_train.py, test_torch_mesh_families.py) --


def nest(flat: dict, prefix: str) -> dict:
    """The reference's tree under ``prefix`` from its flattened leaves."""
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def ref_opt(ref, prefix, kind):
    """A reference ``OptState`` at step 0 (zero moments) for the converter."""
    from types import SimpleNamespace

    params = nest(ref, prefix)

    def zeros(t):
        return {k: zeros(v) for k, v in t.items()} if isinstance(t, dict) else np.zeros_like(t)

    if kind == "adamw":
        return SimpleNamespace(step=0, m=zeros(params), v=zeros(params))
    from repro_torch.train.optimizer import _factored_shape

    def fac(t):
        if isinstance(t, dict):
            return {k: fac(v) for k, v in t.items()}
        fs = _factored_shape(t.shape)
        return np.zeros(t.shape, np.float32) if fs is None else (
            np.zeros(fs[0], np.float32), np.zeros(fs[1], np.float32))

    return SimpleNamespace(step=0, m=None, v=fac(params))


def gathered_state(state, cfg, mesh, prefix):
    """{"<prefix>/<what>/<reference path>": whole float32 array} of a
    state's parameters and moments, gathered from the ranks' blocks."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.steps import state_specs

    specs, _ = state_specs(state, cfg, mesh)

    def whole(t, spec):  # a copy: the step updates its tensors in place
        return shd.gather(t.detach(), spec, mesh).numpy().copy()

    out = {}
    for n, p in state.params.named_parameters():
        out[f"{prefix}/params/{n}"] = whole(p, specs[f"params/{n}"])
    if state.opt.m is not None:
        for n in state.opt.m:
            out[f"{prefix}/m/{n}"] = whole(state.opt.m[n], specs[f"opt/m/{n}"])
            out[f"{prefix}/v/{n}"] = whole(state.opt.v[n], specs[f"opt/v/{n}"])
    else:
        for k, v in state.opt.v.items():
            for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
                key = f"opt/v/{k}/{i}" if isinstance(v, tuple) else f"opt/v/{k}"
                out[f"{prefix}/v/{k}/{i}"] = whole(t, specs[key])
    return out


def ref_leaf(ref, prefix, name):
    """The reference's leaf for the port's ``name`` (layer i of a stack)."""
    from repro_torch.train.optimizer import reference_leaf

    key, index = reference_leaf(name)
    arr = ref[f"{prefix}/{key.replace('.', '/')}"]
    return arr if index is None else arr[index]
