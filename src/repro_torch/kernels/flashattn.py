"""Flash-attention forward wrapper (port of ``repro/kernels/flashattn.py``).

``flash_attention(q, k, v)`` computes ``softmax(q k^T * hd^-0.5 + mask) v``
for queries ``(B, H, Sq, hd)`` against keys and values ``(B, KH, Skv, hd)``
shared by groups of ``H // KH`` query heads, with an optional causal mask
on absolute positions counted from 0 for both q and k. Scores, softmax and
the accumulator are float32; the output has q's shape and dtype.

On CUDA tensors it runs ``csrc/flashattn.cu`` (head dims 16, 32, 64 and
128; anything else raises); on CPU tensors its plain version
``flash_attention_ref``. bfloat16 takes the tensor-core kernel
(``mma.sync`` m16n8k16 with f32 accumulators; tiles of 64 queries, four
warps of 16 rows, and a two-stage ``cp.async`` ring of 64-key K/V tiles);
float32 takes a CUDA-core kernel in f32 (64 queries, 64-key tiles), since
TF32 products would not hold the float32 model to its CPU copy. Both take
any ``Sq`` and ``Skv`` (the ragged tile is masked) and read every tensor
through its strides, with only the last axis contiguous: a
``(B, S, H, hd)`` activation passed as ``x.transpose(1, 2)`` is read in
place, and the output is allocated with q's strides, so
``out.transpose(1, 2)`` is contiguous again. k and v are staged with
16-byte copies, so their data pointers and strides must be 16-byte
multiples (a fresh tensor's or a projection's view always is); others
raise. The Pallas kernel's ``q_block``/``kv_block`` VMEM tiles have no
counterpart: the CUDA kernels' tiles are fixed.

Against the plain version on the same inputs the kernel is held to atol
1e-4 in float32 and, in bfloat16, to one bfloat16 rounding step of the
plain output, ``|got - want| <= 2**-7 * |want| + 1e-4`` elementwise: both
compute in float32 and round once to bfloat16, so they differ by at most
the one step that float32 summation order can tip a value across. The
bfloat16 kernel keeps that: q k^T multiplies bf16 values exactly into f32,
and P enters P V as two bf16 halves, ``hi = bf16(p)`` and
``lo = bf16(p - hi)``, whose sum is within 2**-17 of p, where a single bf16
rounding (2**-9) fails the check on outputs that nearly cancel
(``tests/test_torch_flashattn.py`` emulates both).
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MASKED = -1e30  # the score of a masked key, as in the Pallas kernel
_GRID_MAX = 65535  # CUDA's limit on a grid's y (heads) and z (batch) extents


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention wants q (B, H, Sq, hd) and k, v (B, KH, Skv, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or head_dim")
    KH = k.shape[1]
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads do not split into groups over {KH} KV heads")
    if k.shape[2] == 0 and q.shape[2] > 0:
        raise ValueError("flash_attention needs at least one key")


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Plain version: the whole (Sq, Skv) score matrix in float32, masked
    scores -1e30, softmax, then the value sum; cast to q's dtype."""
    _check_shapes(q, k, v)
    B, H, Sq, hd = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    qf = q.float().reshape(B, KH, G, Sq, hd) * hd**-0.5
    s = torch.einsum("bkgqh,bksh->bkgqs", qf, k.float())
    if causal:
        keep = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Skv, device=q.device)
        s = torch.where(keep, s, torch.full((), MASKED, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", w, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """``(B, H, Sq, hd)`` attention output in q's dtype (see the module
    docstring)."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    B, H, Sq, hd = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash kernel takes float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if B > _GRID_MAX or H > _GRID_MAX:
        raise ValueError(f"batch {B} or heads {H} exceed the kernel grid's {_GRID_MAX}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous last axis, got strides {t.stride()}")
    for name, t in (("k", k), ("v", v)):
        size = t.element_size()
        if t.data_ptr() % 16 or any(
            n > 1 and st * size % 16 for n, st in zip(t.shape[:3], t.stride()[:3])
        ):
            raise ValueError(
                f"{name} must start and step in 16-byte multiples, got address "
                f"{t.data_ptr()} and strides {t.stride()} of {size}-byte elements"
            )
    out = torch.empty_like(q)  # keeps a dense q's strides: a transposed view stays one
    if Sq == 0 or B == 0 or H == 0:
        return out
    lib = _lib.load()

    def strides(t):  # (batch, head, position) strides in elements
        return t.stride(0), t.stride(1), t.stride(2)

    _lib.check(
        lib.pb_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KH, Sq, Skv, hd,
            _DTYPE_CODE[q.dtype], int(causal), hd**-0.5,
            *strides(q), *strides(k), *strides(v), *strides(out), _lib.stream(q),
        ),
        "flash attention kernel",
    )
    _lib.count_launch(flash_attention, (B, H, KH, Sq, Skv, hd))
    return out


flash_attention.launches, flash_attention.shapes = 0, {}


def flash_hbm_bytes(B, H, KH, Sq, Skv, hd, q_block: int = 128, dtype_bytes: int = 2) -> int:
    """Device-memory traffic of the reference's flash kernel: Q read and O
    written once; K/V streamed once per query-block pass (nq passes)."""
    q_o = 2 * B * H * Sq * hd * dtype_bytes
    nq = max(1, Sq // q_block)
    kv = 2 * B * KH * Skv * hd * dtype_bytes * nq
    return q_o + kv


def flash_flops(B, H, Sq, Skv, hd, causal: bool) -> float:
    """Multiply-adds of q k^T and p v as FLOP (2 per multiply-add):
    4 * B * H * Sq * Skv * hd, half of it under the causal mask."""
    f = 4.0 * B * H * Sq * Skv * hd
    return f / 2 if causal else f
