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


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False):
        """Copy the leaves to host memory, then write on a worker thread."""
        self.wait()
        named = [(k,) + _to_numpy(v) for k, v in _flatten_with_paths(tree)]

        def work():
            try:
                self._write(step, named)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        if blocking:
            self._write(step, named)
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _write(self, step: int, named):
        path = os.path.join(self.dir, f"step_{step:010d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        arrays = {}
        for i, (k, v, dtype) in enumerate(named):
            name = f"leaf_{i:05d}"
            arrays[name] = v
            manifest["leaves"][name] = {
                "path": k,
                "shape": list(v.shape),
                "dtype": dtype,
                "adler32": zlib.adler32(np.asarray(v, order="C")),
            }
        _write_npz(os.path.join(tmp, "shard-0.npz"), arrays)
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

    def _verify(self, step: int) -> Optional[Tuple[dict, Dict[str, np.ndarray]]]:
        """(manifest, leaf name -> array) of a step whose every checksum
        holds; None, with a message, for a torn or corrupt one."""
        path = os.path.join(self.dir, f"step_{step:010d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            arrays = {}
            with np.load(os.path.join(path, "shard-0.npz")) as data:
                for name, meta in manifest["leaves"].items():
                    arr = data[name]
                    if zlib.adler32(np.asarray(arr, order="C")) != meta["adler32"]:
                        raise IOError(f"checksum mismatch in {name} ({meta['path']})")
                    arrays[name] = arr
            return manifest, arrays
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            # the failure modes of a torn or corrupt step: missing files or a
            # checksum (OSError), bad json or npz payload (ValueError,
            # BadZipFile), a truncated manifest (KeyError). Anything else is
            # a real bug: let it raise.
            print(f"[ckpt] step {step} unusable: {e}")
            return None

    def restore(self, target_tree, step: Optional[int] = None):
        """(a tree shaped like ``target_tree`` holding the newest complete
        step, or ``step``; that step), or (None, None). Leaves take the
        target's devices and dtypes; the target is not written. The stored
        leaf paths must be the target's."""
        steps = self.all_steps()
        if step is not None:
            steps = [s for s in steps if s == step]
        for s in reversed(steps):
            got = self._verify(s)
            if got is None:
                continue  # torn checkpoint: fall back to the previous one
            manifest, arrays = got
            targets = list(_flatten_with_paths(target_tree))
            stored = [(meta["path"], name, meta["dtype"])
                      for name, meta in manifest["leaves"].items()]
            if [p for p, _, _ in stored] != [p for p, _ in targets]:
                raise ValueError(
                    f"step {s} holds leaves {[p for p, _, _ in stored]}, the target "
                    f"{[p for p, _ in targets]}")
            leaves = {p: _from_numpy(arrays[name], dtype, like)
                      for (p, name, dtype), (_, like) in zip(stored, targets)}
            return _rebuild(target_tree, "", leaves), s
        return None, None
