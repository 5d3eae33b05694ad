"""Checkpoints with an async save, an integrity manifest and auto-resume
(port of ``repro/checkpoint/manager.py``), on the reference's on-disk
design:

  step_<step>/manifest.json  step, tree, per-leaf path, shape, dtype, adler32
  step_<step>/shard-0.npz    the leaves (one host: whole tensors)

- ``save`` copies the tensors to host memory on the caller's thread,
  then writes on a worker thread; ``wait()`` joins it (a save waits for
  the previous one first). A step is written under ``.tmp`` and renamed
  into place when complete.
- ``restore`` checks every leaf's adler32; a torn or corrupt step is
  reported and skipped, falling back to the previous complete one.
- ``keep_n`` garbage collection keeps the newest steps.

On a mesh (``distributed/sharding.py``) a tree's tensors are each rank's
blocks, and a step is saved in blocks, every rank writing its own file in
parallel:

  step_<step>/shard-<rank>.npz  the blocks this rank alone holds
  step_<step>/part-<rank>.json  their paths, shapes, dtypes, adler32s
  step_<step>/manifest.json     the mesh, each leaf's spec and whole shape,
                                the parts (rank 0 writes it once every
                                part has arrived, then publishes the step)

``restore(mesh=, specs=)`` assembles each of this rank's blocks under the
specs of the mesh it restores onto, which may have another shape (the
counterpart of the reference's ``restore(tree, shardings=)``), from the
saved blocks it overlaps, and checks those; a step saved in blocks also
restores on one device, and one saved whole onto a mesh. Every rank's
blocks are the saved values bit for bit.

Leaves are named by their path in the tree: a ``TrainState``'s are
``params/<parameter name>``, ``opt/step``, ``opt/m/<name>`` and
``opt/v/<key>`` (``/0``, ``/1`` for Adafactor's factors). A tree is built
of NamedTuples, dicts, tuples, ``nn.Module``s (their named parameters),
tensors, Python numbers and ``None`` (no leaf). numpy has no bfloat16: a
bfloat16 tensor is stored as its int16 bits, with dtype ``bfloat16`` in
the manifest, and comes back bit for bit.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _flatten_with_paths(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    def sub(k):
        return f"{path}/{k}" if path else str(k)

    if tree is None:
        return
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield sub(name), p
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten_with_paths(getattr(tree, f), sub(f))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_with_paths(v, sub(k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, sub(i))
    else:
        yield path, tree


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, like) -> Any:
    """A leaf shaped like ``like`` (a tensor: its device and dtype; a
    Python number: its type) from a stored array."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr)  # np.load's arrays are fresh and writable
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device=like.device, dtype=like.dtype)
    return type(like)(arr.item())


def _rebuild(tree, path: str, leaves: Dict[str, Any]):
    """``tree`` with each leaf replaced by ``leaves[path]``; modules are
    copied, never written."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)

    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        new = copy.deepcopy(tree)
        with torch.no_grad():
            for name, p in new.named_parameters():
                p.copy_(leaves[sub(name)])
        return new
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), sub(f), leaves) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(v, sub(k), leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, sub(i), leaves) for i, v in enumerate(tree))
    return leaves[path]


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez(path, **arrays)``'s file (a zip of ``.npy`` entries,
    stored), with each array's bytes written from a view: ``np.savez``
    copies them in 16 MiB chunks, which costs a third of a 15 GB save."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, v in arrays.items():
            v = np.asarray(v, order="C")
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, np.lib.format.header_data_from_array_1_0(v))
                f.write(memoryview(v.reshape(-1)).cast("B"))


PUBLISH_TIMEOUT = 3600.0  # seconds rank 0 waits for the other ranks' parts of a step


def _block_ranges(shape, spec, mesh_shape: dict, rank: int) -> List[Tuple[int, int]]:
    """[start, stop) along each dim of rank ``rank``'s block of a tensor of
    ``shape`` under ``spec`` on a mesh of ``mesh_shape`` (the whole range
    where ``spec`` is None)."""
    from repro_torch.distributed.sharding import Mesh, entry_axes

    if not spec:
        return [(0, n) for n in shape]
    mesh = Mesh(mesh_shape, rank=rank)
    out = []
    for n, e in zip(shape, spec):
        axes = entry_axes(e)
        b = n // mesh.axis_size(axes)
        i = mesh.axis_index(axes)
        out.append((i * b, (i + 1) * b))
    return out


def _spec_to_json(spec):
    return None if spec is None else [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec_from_json(spec):
    return None if spec is None else tuple(tuple(e) if isinstance(e, list) else e for e in spec)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False, mesh=None, specs=None,
             shapes=None):
        """Copy the leaves to host memory, then write on a worker thread.
        On a ``mesh`` every rank calls it: ``specs`` and ``shapes`` map a
        leaf's path to its spec and whole shape (a path absent from
        ``specs`` is replicated). Each rank writes the blocks it holds
        alone (those of a rank at coordinate 0 of every axis the leaf is not
        sharded on; rank 0 writes the replicated leaves), and rank 0
        publishes the step once every rank's part is on disk."""
        self.wait()
        if mesh is None:
            named = [(k,) + _to_numpy(v) for k, v in _flatten_with_paths(tree)]
            rank, layout = 0, None
        else:
            from repro_torch.distributed.sharding import spec_axes

            rank = mesh.rank
            named, layout = [], {"mesh": dict(mesh.shape), "ranks": mesh.size, "leaves": {}}
            for k, v in _flatten_with_paths(tree):
                spec = specs.get(k) if isinstance(v, torch.Tensor) else None
                sharded = spec_axes(spec) if spec else ()
                layout["leaves"][k] = {
                    "spec": _spec_to_json(spec),
                    "shape": list(shapes.get(k, v.shape)) if isinstance(v, torch.Tensor) else []}
                if all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in sharded):
                    named.append((k,) + _to_numpy(v))

        def work():
            try:
                self._write(step, named, rank, layout)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        if blocking:
            self._write(step, named, rank, layout)
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _write(self, step: int, named, rank: int = 0, layout=None):
        path = os.path.join(self.dir, f"step_{step:010d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        leaves, arrays = {}, {}
        for i, (k, v, dtype) in enumerate(named):
            name = f"leaf_{i:05d}"
            arrays[name] = v
            leaves[name] = {
                "path": k,
                "shape": list(v.shape),
                "dtype": dtype,
                "adler32": zlib.adler32(np.asarray(v, order="C")),
            }
        _write_npz(os.path.join(tmp, f"shard-{rank}.npz"), arrays)
        if layout is None:
            manifest = {"step": step, "leaves": leaves}
        else:
            # this rank's part, renamed into place once whole: its presence
            # says the rank's shard is complete
            part = os.path.join(tmp, f"part-{rank}.json")
            with open(part + ".w", "w") as f:
                json.dump(leaves, f)
            os.replace(part + ".w", part)
            if rank != 0:
                return
            parts = {}
            deadline = time.monotonic() + PUBLISH_TIMEOUT
            for r in range(layout["ranks"]):
                name = os.path.join(tmp, f"part-{r}.json")
                while not os.path.exists(name):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"step {step}: rank {r}'s shard never arrived")
                    time.sleep(0.05)
                with open(name) as f:
                    parts[str(r)] = json.load(f)
            manifest = {"step": step, "mesh": layout["mesh"], "layout": layout["leaves"],
                        "shards": parts}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)  # atomic publish
        self._gc()

    def wait(self):
        """Join the pending save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                try:
                    out.append(int(n.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: int, targets, mesh, specs) -> Optional[Dict[str, Any]]:
        """{path: leaf like its target} of a step whose every checksum read
        holds; None, with a message, for a torn or corrupt one. On a
        ``mesh``, each leaf is this rank's block under ``specs``: from a
        step saved whole, cut from the whole array; from a step saved in
        blocks, assembled from the saved blocks it overlaps (only those are
        read and checked)."""
        path = os.path.join(self.dir, f"step_{step:010d}")
        want_paths = [p for p, _ in targets]
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            if "mesh" not in manifest:
                arrays = {}
                with np.load(os.path.join(path, "shard-0.npz")) as data:
                    for name, meta in manifest["leaves"].items():
                        arr = data[name]
                        if zlib.adler32(np.asarray(arr, order="C")) != meta["adler32"]:
                            raise IOError(f"checksum mismatch in {name} ({meta['path']})")
                        arrays[name] = arr
                stored = [(meta["path"], name, meta["dtype"])
                          for name, meta in manifest["leaves"].items()]
                if [p for p, _, _ in stored] != want_paths:
                    raise _Mismatch(step, [p for p, _, _ in stored], want_paths)
                if mesh is not None:
                    from repro_torch.distributed.sharding import shard_of

                    arrays = {name: np.ascontiguousarray(shard_of(
                        torch.from_numpy(arrays[name]), specs[p], mesh).numpy())
                              if specs.get(p) else arrays[name] for p, name, _ in stored}
                return {p: _from_numpy(arrays[name], dtype, like)
                        for (p, name, dtype), (_, like) in zip(stored, targets)}
            if list(manifest["layout"]) != want_paths:
                raise _Mismatch(step, list(manifest["layout"]), want_paths)
            blocks: Dict[str, list] = {}
            for r, part in manifest["shards"].items():
                for name, meta in part.items():
                    blocks.setdefault(meta["path"], []).append((int(r), name, meta))
            files: Dict[int, Any] = {}
            leaves = {}
            try:
                for p, like in targets:
                    lay = manifest["layout"][p]
                    shape = tuple(lay["shape"])
                    mine = (_block_ranges(shape, specs.get(p), mesh.shape, mesh.rank)
                            if mesh is not None and specs.get(p) else [(0, n) for n in shape])
                    out, dtype = None, None
                    for r, name, meta in blocks[p]:
                        theirs = _block_ranges(shape, _spec_from_json(lay["spec"]),
                                               manifest["mesh"], r)
                        cut = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(mine, theirs)]
                        if any(a >= b for a, b in cut):
                            continue
                        if r not in files:
                            files[r] = np.load(os.path.join(path, f"shard-{r}.npz"))
                        arr = files[r][name]
                        if zlib.adler32(np.asarray(arr, order="C")) != meta["adler32"]:
                            raise IOError(f"checksum mismatch in {name} of shard {r} ({p})")
                        dtype = meta["dtype"]
                        if out is None:
                            out = np.empty(tuple(b - a for a, b in mine), arr.dtype)
                        out[tuple(slice(a - m0, b - m0) for (a, b), (m0, _) in zip(cut, mine))] = \
                            arr[tuple(slice(a - t0, b - t0) for (a, b), (t0, _) in zip(cut, theirs))]
                    if out is None:
                        raise KeyError(f"no saved block of {p}")
                    leaves[p] = _from_numpy(out, dtype, like)
            finally:
                for f in files.values():
                    f.close()
            return leaves
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            if isinstance(e, _Mismatch):
                raise
            # the failure modes of a torn or corrupt step: missing files or a
            # checksum (OSError), bad json or npz payload (ValueError,
            # BadZipFile), a truncated manifest (KeyError). Anything else is
            # a real bug: let it raise.
            print(f"[ckpt] step {step} unusable: {e}")
            return None

    def restore(self, target_tree, step: Optional[int] = None, mesh=None, specs=None):
        """(a tree shaped like ``target_tree`` holding the newest complete
        step, or ``step``; that step), or (None, None). Leaves take the
        target's devices and dtypes; the target is not written. The stored
        leaf paths must be the target's. On a ``mesh`` the target holds
        this rank's blocks and ``specs`` maps a path to its spec there; a
        step saved on any mesh, or whole, restores onto any mesh."""
        steps = self.all_steps()
        if step is not None:
            steps = [s for s in steps if s == step]
        targets = list(_flatten_with_paths(target_tree))
        for s in reversed(steps):
            leaves = self._load(s, targets, mesh, specs)
            if leaves is None:
                continue  # torn checkpoint: fall back to the previous one
            return _rebuild(target_tree, "", leaves), s
        return None, None


class _Mismatch(ValueError):
    """A complete step whose leaves are not the target's."""

    def __init__(self, step, stored, target):
        super().__init__(f"step {step} holds leaves {stored}, the target {target}")
