"""Build and bind the port's CUDA kernels (plain C interface + ctypes).

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links them into one
``libpb_kernels.so``. The library goes into ``_build/<hash>/``, where the
hash covers the sources, the flags and ``nvcc --version``, so a stale
library is never loaded after an edit. ``_build/`` is listed in
``.gitignore``. Nothing here runs at import time: this module imports on
machines without ``nvcc`` or a card, where only the plain versions run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libpb_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# name -> (argtypes, restype) of every C entry point in csrc/
SIGNATURES = {
    "pb_histogram": ([_P, _L, _P, _I, _P], _I),
    "pb_positions_scratch": ([_L, _I, _I], _L),
    "pb_counting_positions": ([_P, _L, _P, _I, _P, _P, _I, _P], _I),
    "pb_fused_scratch": ([_L, _I, _I], _L),
    "pb_fused_accumulate": ([_P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _I, _L, _P, _P], _I),
    "pb_fused_accumulate_rows": ([_P, _P, _L, _I, _P, _I, _I, _I, _P], _I),
    "pb_fused_accumulate_rows_bf16": ([_P, _P, _L, _I, _P, _P, _I, _I, _P], _I),
    "pb_cobra_pass_scratch": ([_L, _I, _I], _L),
    "pb_cobra_pass": ([_P, _P, _P, _L, _P, _I, _P, _P, _P, _I, _P], _I),
    "pb_binread_scatter_add": ([_P, _P, _I, _I, _I, _I, _P, _P, _I, _P], _I),
    "pb_scatter_rows": ([_P, _P, _L, _L, _P, _L, _P], _I),
    "pb_flash_attention": (
        [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _I, ctypes.c_float] + [_L] * 12 + [_P], _I
    ),
    "pb_error_string": ([_I], ctypes.c_char_p),
}


def nvcc_path() -> str | None:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default prefix
    return default if os.path.isfile(default) else None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build_dir(nvcc: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(COMPILE_FLAGS).encode())
    h.update(subprocess.run([nvcc, "--version"], capture_output=True, check=True).stdout)
    return BUILD_ROOT / h.hexdigest()[:16]


def _build(nvcc: str, dest: Path) -> None:
    """Compile each source in parallel, link, and move into ``dest``."""
    tmp = dest.parent / f"{dest.name}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    procs = []
    for src in _sources():
        obj = tmp / f"{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log = []
    failed = []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME)] + [str(o) for _, o, _ in procs]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    try:
        os.rename(tmp, dest)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises without ``nvcc``."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the repro_torch CUDA kernels are "
            "built from src/repro_torch/kernels/csrc at first use"
        )
    dest = build_dir(nvcc)
    if not (dest / LIB_NAME).exists():
        _build(nvcc, dest)
    lib = ctypes.CDLL(str(dest / LIB_NAME))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.build_dir = dest
    return lib


def build_log() -> str:
    """What nvcc printed for the loaded library (``-Xptxas -v``)."""
    path = load().build_dir / "build.log"
    return path.read_text() if path.exists() else ""


def kernel_sass(name_part: str) -> dict:
    """``cuobjdump -sass`` of the loaded library (the toolkit's, beside
    nvcc): mangled name -> SASS of every kernel whose name holds
    ``name_part``."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(load().build_dir / LIB_NAME)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        if name_part in name:
            out[name.strip()] = body
    return out


def require_cuda(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    """A kernel takes contiguous CUDA tensors of one dtype; raise otherwise."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        msg = load().pb_error_string(status)
        raise RuntimeError(f"{what} failed: CUDA error {status} ({msg.decode()})")


def count_launch(wrapper, shape: tuple) -> None:
    """One launch of ``wrapper``'s kernel: its count, and its count at ``shape``."""
    wrapper.launches += 1
    wrapper.shapes[shape] = wrapper.shapes.get(shape, 0) + 1


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


INT32_MAX = 2**31 - 1


def check_int32_size(n: int, what: str) -> None:
    """The kernels address with int32; larger sizes are refused."""
    if n > INT32_MAX:
        raise ValueError(f"{what} = {n} exceeds int32 addressing of the CUDA kernels")
