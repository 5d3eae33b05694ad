"""The port's flash attention on the CPU against the JAX package.

The wrapper runs its plain version on CPU tensors; it is held against
``repro.kernels.flashattn.flash_attention_pallas`` (interpret mode) at the
reference test's parameters (``tests/test_kernels.py:199-221``: float32
atol 1e-4, bfloat16 atol 5e-2), and the model's routing of attention
through it (``repro_torch.models.layers.blockwise_attention``) against the
reference's ``blockwise_attention`` and ``_direct_attention`` on ragged
lengths with qwen2's head grouping (G = 6, hd = 128), float32 atol 1e-4.
The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Its bfloat16
arithmetic (tensor-core products, P split into two bfloat16 halves) is
emulated here in plain torch and held to the card's bfloat16 check.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn import flash_attention_pallas
from repro.kernels.flashattn import flash_hbm_bytes as ref_flash_hbm_bytes
from repro.models import layers as RL
from repro_torch.kernels.flashattn import (
    flash_attention,
    flash_attention_ref,
    flash_flops,
    flash_hbm_bytes,
)
from repro_torch.models import layers as L

ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=shape_q).astype(np.float32)
    k = rng.normal(size=shape_kv).astype(np.float32)
    v = rng.normal(size=shape_kv).astype(np.float32)
    return q, k, v


def _both(a, dtype):
    """The same values (rounded once, to nearest even) on both sides."""
    return jnp.asarray(a, dtype=getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,H,KH,S,hd", [(1, 2, 1, 128, 16), (2, 4, 2, 256, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_pallas_interpret(B, H, KH, S, hd, causal, dtype):
    q, k, v = _inputs((B, H, S, hd), (B, KH, S, hd), seed=B * S + H)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, q_block=64, kv_block=64)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal)
    assert flash_attention.launches == before  # CPU tensors: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=ATOL[dtype], rtol=0
    )


@pytest.mark.parametrize("B,H,KH,S", [(1, 4, 4, 128), (2, 8, 2, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_at_head_dim_80_matches_pallas_interpret(B, H, KH, S, causal, dtype):
    """zamba2's head_dim (80), with one KV head a query head as in zamba2
    and with groups of four (GQA), at the reference test's tolerances."""
    q, k, v = _inputs((B, H, S, 80), (B, KH, S, 80), seed=80 + H)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, q_block=64, kv_block=64)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=ATOL[dtype], rtol=0
    )


@pytest.mark.parametrize("S", [33, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_model_attention_at_head_dim_80_matches_reference(S, causal):
    """The hybrid family's attention route (zamba2's head_dim 80, a KV head
    a query head) against the reference's online-softmax loop and its
    direct attention, float32 atol 1e-4."""
    B, H, KH, hd = 2, 8, 8, 80
    q, k, v = _inputs((B, S, H, hd), (B, S, KH, hd), seed=S + hd)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = L.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    ).numpy()
    blockwise = RL.blockwise_attention(jq, jk, jv, causal=causal, q_block=32, kv_block=32)
    direct = RL._direct_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got, np.asarray(blockwise), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, np.asarray(direct), atol=1e-4, rtol=0)


@pytest.mark.parametrize("S", [33, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_model_attention_matches_reference_on_ragged_lengths(S, causal):
    """(B, S, H, hd) activations, H = 12 over KH = 2, hd = 128: the port's
    blockwise_attention (the kernel's route) against the reference's
    padded online-softmax loop and its direct attention."""
    B, H, KH, hd = 2, 12, 2, 128
    q, k, v = _inputs((B, S, H, hd), (B, S, KH, hd), seed=S)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = L.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    ).numpy()
    blockwise = RL.blockwise_attention(jq, jk, jv, causal=causal, q_block=32, kv_block=32)
    direct = RL._direct_attention(jq, jk, jv, causal=causal)
    assert got.shape == (B, S, H * hd)
    np.testing.assert_allclose(got, np.asarray(blockwise), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, np.asarray(direct), atol=1e-4, rtol=0)


@pytest.mark.parametrize("Sq,Skv", [(1, 1), (7, 7), (40, 65), (65, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_direct_attention_for_any_lengths(Sq, Skv, causal):
    """Sq != Skv: positions count from 0 for both q and k, as in the Pallas
    kernel's mask; the reference's direct attention with q_offset = 0."""
    q, k, v = _inputs((1, Sq, 12, 128), (1, Skv, 2, 128), seed=Sq * 100 + Skv)
    got = flash_attention(
        torch.from_numpy(q).transpose(1, 2), torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), causal=causal,
    ).transpose(1, 2).reshape(1, Sq, -1)
    want = RL._direct_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_plain_flash_reads_strided_views_as_contiguous():
    q, k, v = _inputs((2, 30, 12, 64), (2, 30, 2, 64), seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2))
    want = flash_attention_ref(*(t.transpose(1, 2).contiguous() for t in (tq, tk, tv)))
    assert torch.equal(got, want)


@pytest.mark.parametrize("shapes", [
    ((1, 3, 8, 16), (1, 2, 8, 16)),   # 3 heads over 2 KV heads
    ((1, 2, 8, 16), (1, 1, 0, 16)),   # no keys
    ((1, 2, 8, 16), (1, 1, 8, 32)),   # head_dim differs
    ((2, 2, 8), (2, 1, 8)),           # not 4-D
])
def test_flash_rejects_bad_shapes(shapes):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError):
        flash_attention(q, k, k)


def test_flash_bytes_and_flops_match_the_reference_model():
    for args in [(1, 12, 2, 4096, 4096, 128), (2, 4, 2, 256, 512, 32), (1, 2, 1, 100, 100, 16)]:
        for q_block in (64, 128, 512):
            for nbytes in (2, 4):
                assert flash_hbm_bytes(*args, q_block=q_block, dtype_bytes=nbytes) == \
                    ref_flash_hbm_bytes(*args, q_block=q_block, dtype_bytes=nbytes)
    # the prefill shape of qwen2-1.5b: 5.15e10 FLOP under the causal mask
    assert flash_flops(1, 12, 4096, 4096, 128, causal=True) == 4 * 12 * 4096**2 * 128 / 2
    assert flash_flops(1, 12, 4096, 4096, 128, causal=False) == 4 * 12 * 4096**2 * 128


# -- the bfloat16 kernel's arithmetic, emulated ---------------------------------
# csrc/flashattn.cu multiplies bf16 q, k, v on the tensor cores: f32 scores
# (bf16 products are exact), scaled by hd^-0.5 * log2(e), an online softmax
# over 64-key tiles with exp2, and P V with P split into hi = bf16(p) and
# lo = bf16(p - hi), both products into one f32 accumulator. The emulation
# below repeats that arithmetic and is held to the card's bfloat16 check
# against the plain version: |got - want| <= 2^-7 |want| + 1e-4, one bf16
# step of the plain output (tests/test_torch_cuda.py, chip_smoke.py).

BF16_REL, BF16_FLOOR = 2.0**-7, 1e-4


def _emulate_bf16_kernel(q, k, v, causal, split_p=True, tile=64):
    B, H, Sq, hd = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KH, H // KH, Sq, hd)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(hd**-0.5 * math.log2(math.e), dtype=torch.float32)
    m = torch.full((B, KH, H // KH, Sq), -1e30)
    l = torch.zeros(B, KH, H // KH, Sq)
    acc = torch.zeros(B, KH, H // KH, Sq, hd)
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = torch.einsum("bkgqh,bksh->bkgqs", qf, kt) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(keys <= rows, s, torch.full((), -1e30))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bksh->bkgqh", hi, vt)
        if split_p:
            lo = (p - hi).bfloat16().float()
            acc = acc + torch.einsum("bkgqs,bksh->bkgqh", lo, vt)
        m = mx
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, H, Sq, hd).bfloat16()


def _bf16_misses(got, want):
    """Entries outside one bf16 step of the plain output."""
    diff = (got.float() - want.float()).abs()
    return int((diff > BF16_REL * want.float().abs() + BF16_FLOOR).sum())


def _bf16_qkv(B, H, KH, Sq, Skv, hd, seed, cancel=False):
    """bf16 q, k, v from N(0, 1) (numpy); with ``cancel`` v = +-1 alternating
    by key, so that every output is a near-cancelling sum."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, Sq, hd)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.normal(size=(B, KH, Skv, hd)).astype(np.float32)).bfloat16()
    if cancel:
        sign = 1.0 - 2.0 * (np.arange(Skv) % 2)
        v = np.broadcast_to(sign[None, None, :, None], (B, KH, Skv, hd))
    else:
        v = rng.normal(size=(B, KH, Skv, hd))
    return q, k, torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).bfloat16()


@pytest.mark.parametrize("B,H,KH,S,hd", [
    (1, 2, 2, 128, 16), (1, 2, 2, 512, 128), (1, 2, 2, 2048, 128),  # the design's shapes
    (1, 12, 2, 200, 32), (2, 12, 2, 130, 64), (1, 12, 2, 300, 128),  # qwen-like grouping
    (1, 32, 32, 130, 80), (1, 8, 2, 300, 80),  # zamba2's heads, and head_dim 80 under GQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_arithmetic_holds_the_bf16_check(B, H, KH, S, hd, causal):
    q, k, v = _bf16_qkv(B, H, KH, S, S, hd, seed=0)
    got = _emulate_bf16_kernel(q, k, v, causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert _bf16_misses(got, want) == 0


@pytest.mark.parametrize("Sq", [1, 15, 63, 65, 127, 129])
@pytest.mark.parametrize("Skv", [1, 15, 63, 65, 127, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_arithmetic_on_ragged_lengths(Sq, Skv, causal):
    q, k, v = _bf16_qkv(1, 12, 2, Sq, Skv, 32, seed=Sq * 1000 + Skv)
    got = _emulate_bf16_kernel(q, k, v, causal)
    assert _bf16_misses(got, flash_attention_ref(q, k, v, causal=causal)) == 0


@pytest.mark.parametrize("S,hd", [(128, 16), (512, 128)])
def test_split_p_is_needed_where_outputs_cancel(S, hd):
    """v = +-1 alternating by key: the split-P arithmetic holds the check,
    and a single bf16 rounding of P, as FlashAttention-2 does, fails it."""
    q, k, v = _bf16_qkv(1, 2, 2, S, S, hd, seed=0, cancel=True)
    want = flash_attention_ref(q, k, v, causal=True)
    assert _bf16_misses(_emulate_bf16_kernel(q, k, v, True), want) == 0
    assert _bf16_misses(_emulate_bf16_kernel(q, k, v, True, split_p=False), want) > 0


# -- the bfloat16 kernel's shared-memory layout, emulated -------------------------
# csrc/flashattn.cu keeps the Q tile and the K/V ring as rows of
# row_pitch<HD>() elements (HD rounded up to a power of two: 128 at HD 80)
# whose 16-byte chunks are XOR-swizzled by the row (swizzle<HD>). These
# are the two functions in Python, and the properties the kernel relies on.

TILE_ROWS = 64  # kQTile = kKTile
SMEM_PER_BLOCK = 232_448  # the H100's opt-in limit


def _row_pitch(hd):
    p = 8
    while p < hd:
        p *= 2
    return p


def _swizzle(hd, row, chunk, pitch=None):
    """Element offset of 16-byte chunk ``chunk`` of ``row`` (swizzle<HD>);
    ``pitch`` overrides the row pitch (to show what an unpadded row does)."""
    pitch = pitch or _row_pitch(hd)
    chunks = pitch // 8
    per_line = 1 if chunks >= 8 else 8 // chunks
    spread = 8 if chunks >= 8 else chunks
    return row * pitch + ((chunk ^ ((row // per_line) & (spread - 1))) << 3)


def _layout(hd, pitch=None):
    """(TILE_ROWS, hd / 8) offsets of every (row, chunk) of a tile."""
    rows = np.arange(TILE_ROWS)[:, None]
    chunks = np.arange(hd // 8)[None, :]
    return np.vectorize(lambda r, c: _swizzle(hd, r, c, pitch))(rows, chunks)


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
def test_smem_layout_keeps_every_chunk_in_its_own_row(hd):
    """Every (row, chunk) of a tile maps to a distinct 16-byte-aligned
    offset inside its own row's pitch, and the block's tiles (Q and two
    stages of K and V) fit the card's shared memory: 80 KB at hd 80."""
    pitch = _row_pitch(hd)
    off = _layout(hd)
    assert len(np.unique(off)) == off.size
    assert (off % 8 == 0).all()
    row_start = np.arange(TILE_ROWS)[:, None] * pitch
    assert ((off >= row_start) & (off + 8 <= row_start + pitch)).all()
    smem = (TILE_ROWS + 2 * 2 * TILE_ROWS) * pitch * 2
    assert smem <= SMEM_PER_BLOCK and (hd != 80 or smem == 81_920)


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
def test_smem_layout_gives_ldmatrix_eight_bank_groups(hd):
    """An ldmatrix phase reads one logical chunk of eight consecutive rows:
    their 16-byte bank groups (byte offset / 16 mod 8) are all different."""
    groups = (_layout(hd) * 2 // 16) % 8
    for r0 in range(0, TILE_ROWS, 8):
        for c in range(hd // 8):
            assert len(set(groups[r0:r0 + 8, c])) == 8, (r0, c)


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
def test_smem_layout_serves_every_fragment_from_one_lane_offset(hd):
    """The kernel computes one offset per lane (rows r < 16, chunks c < 2)
    and reaches rows 16 i + r, chunk 2 j ^ c of every fragment as
    16 i pitch + (offset ^ (2 j << 3))."""
    pitch = _row_pitch(hd)
    for i in range(TILE_ROWS // 16):
        for r in range(16):
            for c in range(2):
                lane = _swizzle(hd, r, c)
                for j in range(hd // 16):
                    assert _swizzle(hd, 16 * i + r, (2 * j) ^ c) == 16 * i * pitch + (lane ^ (2 * j << 3))


def test_an_unpadded_80_wide_row_would_break_the_layout():
    """What the padding repairs: with rows 80 elements apart, the XOR of
    chunks 8 and 9 with the row runs past the row's end (and the per-lane
    offset no longer reaches every fragment)."""
    off = _layout(80, pitch=80)
    row_start = np.arange(TILE_ROWS)[:, None] * 80
    assert not ((off >= row_start) & (off + 8 <= row_start + 80)).all()
    lane = _swizzle(80, 1, 0, pitch=80)
    assert _swizzle(80, 1, 2, pitch=80) != lane ^ (2 << 3)
