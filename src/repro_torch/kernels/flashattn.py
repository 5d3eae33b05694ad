"""Flash-attention forward wrapper (port of ``repro/kernels/flashattn.py``).

``flash_attention(q, k, v)`` computes ``softmax(q k^T * hd^-0.5 + mask) v``
for queries ``(B, H, Sq, hd)`` against keys and values ``(B, KH, Skv, hd)``
shared by groups of ``H // KH`` query heads, with an optional causal mask
on absolute positions counted from 0 for both q and k. Scores, softmax and
the accumulator are float32; the output has q's shape and dtype.

On CUDA tensors it runs ``csrc/flashattn.cu`` (head dims 16, 32, 64, 80
and 128; anything else raises, and never reaches the plain version); on
CPU tensors its plain version ``flash_attention_ref``. bfloat16 takes
Hopper's tensor-core kernel: a producer warp issues TMA loads of Q and of
64-key K/V tiles into a ring of up to four ``mbarrier`` stages, and one or
two consumer warpgroups of 64 query rows each run ``wgmma`` for ``q k^T``
(both operands in shared memory) and for ``p v`` (p from registers). float32
takes a CUDA-core kernel in f32 (64 queries, 64-key tiles), since TF32
products would not hold the float32 model to its CPU copy. Both take any
``Sq`` and ``Skv`` (the ragged tile is masked) and read every tensor
through its strides, with only the last axis contiguous: a
``(B, S, H, hd)`` activation passed as ``x.transpose(1, 2)`` is read in
place, and the output is allocated with q's strides, so
``out.transpose(1, 2)`` is contiguous again. k and v are read by TMA (or
staged with 16-byte copies in float32), so their data pointers and strides
must be 16-byte multiples (a fresh tensor's or a projection's view always
is); others raise. A bfloat16 q that TMA cannot read in place (a pointer
or stride off 16 bytes) is passed as an aligned copy, with the same
result. The Pallas kernel's ``q_block``/``kv_block`` VMEM tiles have no
counterpart: the CUDA kernels' tiles are fixed.

Against the plain version on the same inputs the kernel is held to atol
1e-4 in float32 and, in bfloat16, to one bfloat16 rounding step of the
plain output, ``|got - want| <= 2**-7 * |want| + 1e-4`` elementwise: both
compute in float32 and round once to bfloat16, so they differ by at most
the one step that float32 summation order can tip a value across. The
bfloat16 kernel keeps that: q k^T multiplies bf16 values exactly into f32,
and P enters P V as two bf16 halves, ``hi = bf16(p)`` and
``lo = bf16(p - hi)`` (two ``wgmma`` a 16-key step), whose sum is within
2**-17 of p, where a single bf16 rounding (2**-9) fails the check on
outputs that nearly cancel (``tests/test_torch_flashattn.py`` emulates
both).
``flash_attention.launches`` counts kernel launches.

``flash_attention`` is differentiable in q, k and v
(``_FlashAttention``): the backward is the plain function's gradient,
recomputed in float32 from the saved inputs by blocks of ``q_block``
queries (``attention_grads``) on whatever device they lie, as the
reference differentiates its plain ``_blockwise_attention``; the
reference has no backward kernel, and neither has the port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

HEAD_DIMS = (16, 32, 64, 80, 128)
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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, q_offset: int = 0
) -> torch.Tensor:
    """Plain version: the whole (Sq, Skv) score matrix in float32, masked
    scores -1e30, softmax, then the value sum; cast to q's dtype. The
    queries sit at positions ``q_offset`` on (the backward's query
    blocks); the keys at 0 on."""
    _check_shapes(q, k, v)
    B, H, Sq, hd = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    qf = q.float().reshape(B, KH, G, Sq, hd) * hd**-0.5
    s = torch.einsum("bkgqh,bksh->bkgqs", qf, k.float())
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        keep = qpos[:, None] >= torch.arange(Skv, device=q.device)
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
    q_block: int = 512,
) -> torch.Tensor:
    """``(B, H, Sq, hd)`` attention output in q's dtype (see the module
    docstring), differentiable in q, k and v. ``q_block`` is the query
    rows of one step of the backward (see ``_FlashAttention``)."""
    _check_shapes(q, k, v)
    if q_block < 1:
        raise ValueError(f"q_block must be positive, got {q_block}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_block)
    return _forward(q, k, v, causal)  # nothing to differentiate: no autograd node


def _forward(q, k, v, causal: bool) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones, the meta
    route on meta ones."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type == "meta":
        return _flash_forward_meta(q, k, v, causal)
    return _flash_forward_cuda(q, k, v, causal)


def attention_grads(q, k, v, g, *, causal: bool, q_block: int):
    """Gradients (dq, dk, dv) of the plain function at (q, k, v) for the
    output cotangent ``g``, in the inputs' dtypes: autograd of
    ``flash_attention_ref`` in float32, one block of ``q_block`` queries at
    a time, so that no more than (B, H, q_block, Skv) scores live at once.
    Under the causal mask a block needs only the keys up to its last
    query. A GQA group's k and v gradients sum over its query heads (the
    einsum's own backward), and over the blocks in float32."""
    Sq, Skv = q.shape[2], k.shape[2]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kf, vf = k.detach().float(), v.detach().float()
    for s in range(0, Sq, q_block):
        e = min(s + q_block, Sq)
        n = min(e, Skv) if causal else Skv
        with torch.enable_grad():
            qb = q[:, :, s:e].detach().float().requires_grad_()
            kb = kf[:, :, :n].requires_grad_()
            vb = vf[:, :, :n].requires_grad_()
            out = flash_attention_ref(qb, kb, vb, causal=causal, q_offset=s)
            gq, gk, gv = torch.autograd.grad(out, (qb, kb, vb), g[:, :, s:e].float())
        dq[:, :, s:e] = gq
        dk[:, :, :n] += gk
        dv[:, :, :n] += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU ones.
    Backward: the gradient of the plain function, recomputed from the
    saved q, k and v (``attention_grads``), as the reference differentiates
    its plain-jnp ``_blockwise_attention`` (it has no flash backward
    kernel either). The kernel's bfloat16 output differs from the plain
    one by at most one rounding step (module docstring); the gradient is
    the plain function's."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_block):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_block = causal, q_block
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_grads(q, k, v, g, causal=ctx.causal, q_block=ctx.q_block)
        return dq, dk, dv, None, None


def _check_kernel_shape(q) -> None:
    """What the kernel takes on any device: float32 or bfloat16, a head
    dim it is built for, a grid within CUDA's limits."""
    B, H, _, hd = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash kernel takes float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if B > _GRID_MAX or H > _GRID_MAX:
        raise ValueError(f"batch {B} or heads {H} exceed the kernel grid's {_GRID_MAX}")


def _flash_forward_meta(q, k, v, causal: bool) -> torch.Tensor:
    """The meta route (``_lib.meta_call``): the kernel's checks of shape
    and dtype, q's shape and strides, and the kernel's FLOPs
    (``flash_flops``) and bytes (q, k, v read and the output written
    once)."""
    _check_kernel_shape(q)
    B, H, Sq, hd = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    nbytes = q.element_size() * (2 * B * H * Sq * hd + 2 * B * KH * Skv * hd)
    _lib.meta_call(flash_attention, flash_flops(B, H, Sq, Skv, hd, causal), nbytes)
    return torch.empty_like(q)


def _steps_16(t) -> bool:
    """A 16-byte aligned pointer, and a 16-byte multiple for the stride of
    every axis longer than 1."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or st * size % 16 == 0 for n, st in zip(t.shape[:3], t.stride()[:3])
    )


def _flash_forward_cuda(q, k, v, causal: bool) -> torch.Tensor:
    """Launch ``csrc/flashattn.cu`` (inputs checked; see the module
    docstring); counts the launch on ``flash_attention``."""
    B, H, Sq, hd = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    _check_kernel_shape(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous last axis, got strides {t.stride()}")
    for name, t in (("k", k), ("v", v)):
        if not _steps_16(t):
            raise ValueError(
                f"{name} must start and step in 16-byte multiples, got address "
                f"{t.data_ptr()} and strides {t.stride()} of {t.element_size()}-byte elements"
            )
    out = torch.empty_like(q)  # keeps a dense q's strides: a transposed view stays one
    if Sq == 0 or B == 0 or H == 0:
        return out
    if q.dtype == torch.bfloat16 and not _steps_16(q):  # TMA reads an aligned copy
        q = torch.empty(q.shape, dtype=q.dtype, device=q.device).copy_(q)
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
