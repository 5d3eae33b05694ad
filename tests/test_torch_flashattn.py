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
# with exp2 over the key tiles of each block of queries (only the tiles the
# block's last query can see), and P V with P split into hi = bf16(p) and
# lo = bf16(p - hi), both products into one f32 accumulator. The emulation
# below repeats that arithmetic at the kernel's block and key tile and is
# held to the card's bfloat16 check against the plain version:
# |got - want| <= 2^-7 |want| + 1e-4, one bf16 step of the plain output
# (tests/test_torch_cuda.py, chip_smoke.py).

BF16_REL, BF16_FLOOR = 2.0**-7, 1e-4
SMS = 132  # the H100's SMs, which the host's choice of block reads


def _block_rows(B, H, Sq, sms=SMS):
    """Queries a block (bf16::launch): 128, two consumer warpgroups, unless
    that grid has fewer blocks than the card has SMs; then 64."""
    return 128 if -(-Sq // 128) * H * B >= sms else 64


KEYS = 64  # keys a ring stage (Geo::kKeys)


def _n_tiles(q0, rows, Sq, Skv, keys, causal):
    """Key tiles of the block of queries [q0, q0 + rows): the producer's and
    the consumers' loop count. Under the causal mask a block's last query
    sees no key past itself."""
    q_end = min(q0 + rows, Sq)
    kv_end = min(q_end, Skv) if causal else Skv
    return -(-kv_end // keys)


def _emulate_bf16_kernel(q, k, v, causal, split_p=True, rows=None, keys=None, all_tiles=False):
    """The kernel's arithmetic, block by block of ``rows`` queries (default:
    the host's choice) over its ``keys``-key tiles (``all_tiles``: every
    tile of the keys, as if none were skipped)."""
    B, H, Sq, hd = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    rows = rows or _block_rows(B, H, Sq)
    keys = keys or KEYS
    kf, vf = k.float(), v.float()
    scale = torch.tensor(hd**-0.5 * math.log2(math.e), dtype=torch.float32)
    out = torch.empty(B, KH, H // KH, Sq, hd, dtype=torch.bfloat16)
    for q0 in range(0, Sq, rows):
        qf = q[:, :, q0:q0 + rows].float().reshape(B, KH, H // KH, -1, hd)
        n = qf.shape[3]
        m = torch.full((B, KH, H // KH, n), -1e30)
        l = torch.zeros(B, KH, H // KH, n)
        acc = torch.zeros(B, KH, H // KH, n, hd)
        qpos = torch.arange(q0, q0 + n)[:, None]
        tiles = -(-Skv // keys) if all_tiles else _n_tiles(q0, rows, Sq, Skv, keys, causal)
        for k0 in range(0, tiles * keys, keys):
            kt, vt = kf[:, :, k0:k0 + keys], vf[:, :, k0:k0 + keys]
            s = torch.einsum("bkgqh,bksh->bkgqs", qf, kt) * scale
            if causal:
                kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
                s = torch.where(kpos <= qpos, s, torch.full((), -1e30))
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
        out[:, :, :, q0:q0 + n] = (acc / l.clamp(min=1e-30)[..., None]).bfloat16()
    return out.reshape(B, H, Sq, hd)


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


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_arithmetic_in_both_blocks(hd, rows, causal):
    """Each block (64 queries, or 128 in two warpgroups) over 64-key tiles,
    at 257 queries and keys: ragged last tiles, and a last block of one
    query."""
    q, k, v = _bf16_qkv(1, 4, 2, 257, 257, hd, seed=hd + rows)
    got = _emulate_bf16_kernel(q, k, v, causal, rows=rows)
    assert _bf16_misses(got, flash_attention_ref(q, k, v, causal=causal)) == 0


@pytest.mark.parametrize("Sq,Skv", [(64, 64), (127, 129), (128, 128), (129, 127), (129, 257),
                                    (257, 129), (1, 129), (129, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_on_ragged_lengths_in_128_query_blocks(Sq, Skv, causal):
    """hd 80 (zamba2's heads, 64 + 16 columns) in 128-query blocks over
    64-key tiles, lengths on both sides of both tiles."""
    q, k, v = _bf16_qkv(1, 8, 2, Sq, Skv, 80, seed=Sq * 1000 + Skv)
    got = _emulate_bf16_kernel(q, k, v, causal, rows=128)
    assert _bf16_misses(got, flash_attention_ref(q, k, v, causal=causal)) == 0


@pytest.mark.parametrize("hd", [80, 128])
@pytest.mark.parametrize("rows", [64, 128])
def test_split_p_is_needed_where_outputs_cancel_in_both_blocks(hd, rows):
    """The cancellation case (v = +-1 by key) at the new blocks and tiles:
    hi + lo holds the check; P rounded to bf16 once fails it."""
    q, k, v = _bf16_qkv(1, 2, 2, 512, 512, hd, seed=1, cancel=True)
    want = flash_attention_ref(q, k, v, causal=True)
    assert _bf16_misses(_emulate_bf16_kernel(q, k, v, True, rows=rows), want) == 0
    assert _bf16_misses(_emulate_bf16_kernel(q, k, v, True, False, rows=rows), want) > 0


@pytest.mark.parametrize("rows,keys", [(64, 64), (128, 64), (128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_block_tile_count_loads_every_visible_key_and_no_more(rows, keys, causal):
    """The producer's and consumers' n_tiles: for every block, the tiles
    reach the last key any of its queries sees, and the last tile holds
    one such key (no tile wholly out of sight is loaded)."""
    for Sq in (1, 63, 64, 65, 127, 128, 129, 255, 257, 300):
        for Skv in (1, 63, 64, 65, 127, 128, 129, 255, 257, 300):
            for q0 in range(0, Sq, rows):
                n = _n_tiles(q0, rows, Sq, Skv, keys, causal)
                last_query = min(q0 + rows, Sq) - 1
                last_key = min(last_query, Skv - 1) if causal else Skv - 1
                assert (n - 1) * keys <= last_key < n * keys, (Sq, Skv, q0, n)


@pytest.mark.parametrize("rows", [64, 128])
def test_tiles_out_of_a_querys_sight_leave_its_state_unchanged(rows):
    """A tile every key of which is masked for a row adds exp2(-1e30) = 0
    and rescales by exp2(0) = 1: running every tile of the keys gives the
    same bits as the block's count (in a 128-query block the first
    warpgroup's rows run the diagonal tile for the second's)."""
    q, k, v = _bf16_qkv(1, 4, 2, 300, 300, 64, seed=3)
    full = _emulate_bf16_kernel(q, k, v, True, rows=rows, all_tiles=True)
    assert torch.equal(_emulate_bf16_kernel(q, k, v, True, rows=rows), full)


# -- the bfloat16 kernel's shared-memory layout, modelled ------------------------
# csrc/flashattn.cu cuts a row's head_dim into parts of 64 columns and a rest
# (Cols), each a TMA box whose shared-memory rows are exactly its swizzle
# span (128, 64 or 32 bytes), and reads them with wgmma descriptors: K-major
# for Q and K (Q K^T), MN-major for V (P V). Below, in numpy: TMA's swizzle,
# the descriptors' addressing, and the block's budget (Geo), with the
# constants of the kernel.

SMEM_PER_BLOCK = 232_448  # the H100's opt-in limit a block
SMEM_PER_SM = 233_472  # 228 KB an SM, 1 KB of it reserved a resident block
HEAD_DIMS = (16, 32, 64, 80, 128)


def _parts(hd):
    """(first column, width) of each part of a row: 64, then the rest."""
    return [(c, min(64, hd - c)) for c in range(0, hd, 64)]


def _geo(hd, nwg):
    """Queries, keys a stage, bytes of Q and of a K or V tile, stages, and
    the block's dynamic shared memory (Geo<HD, NWG>): as many stages, up to
    four, as fit a block's limit and, for 64-query blocks, two blocks an
    SM."""
    rows, keys, blocks = 64 * nwg, KEYS, 2 if nwg == 1 else 1
    q_bytes, kv_bytes = rows * hd * 2, keys * hd * 2

    def smem(stages):  # Q, the stages' K and V, a barrier for Q and three a stage, alignment
        return q_bytes + 2 * stages * kv_bytes + 8 * (1 + 3 * stages) + 1024

    stages = next(n for n in (4, 3, 2) if smem(n) <= SMEM_PER_BLOCK
                  and blocks * (smem(n) + 1024) <= SMEM_PER_SM)
    return rows, keys, q_bytes, kv_bytes, stages, smem(stages)


def _swizzle(addr, span):
    """The byte address a swizzled layout of ``span``-byte rows puts a
    logical address at (TMA's SWIZZLE_{span}B, wgmma's matching layout):
    the 16-byte chunk bits [4, 4 + b) XOR the bits [7, 7 + b), b = log2(span
    / 16), of a region aligned to 1024 bytes."""
    mask = span // 16 - 1
    return addr ^ (((addr >> 7) & mask) << 4)


def _tma(region, span, row, col):
    """Where TMA stores element (row, col) of a box of ``span``-byte rows."""
    return _swizzle(region + row * span + 2 * col, span)


def _kmajor(start, sbo, span, row, k):
    """The address wgmma reads element (row, k) of a K-major operand at,
    from a descriptor (start, SBO) over ``span``-byte swizzled rows: 8-row
    groups SBO apart, rows ``span`` apart inside a group."""
    return _swizzle(start + (row // 8) * sbo + (row % 8) * span + 2 * k, span)


def _mnmajor(start, lbo, sbo, span, k, n):
    """The same for element (k, n) of an MN-major operand: n runs along a
    row in atoms of ``span`` bytes LBO apart, k over rows, 8-row groups SBO
    apart."""
    atom = span // 2
    return _swizzle(start + (k // 8) * sbo + (k % 8) * span + (n // atom) * lbo + 2 * (n % atom),
                    span)


def _field(nbytes):
    """A descriptor's 14-bit field of 16-byte units (address, LBO or SBO)."""
    assert nbytes % 16 == 0 and nbytes >> 4 < 1 << 14, nbytes
    return nbytes >> 4


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("rows", [64, 128])
def test_tma_boxes_put_every_chunk_of_a_tile_in_a_slot_of_its_own(hd, rows):
    """A tile of ``rows`` rows (Q's 64 or 128, K's and V's 64): every
    (row, 16-byte chunk) of every part at a distinct 16-byte slot inside
    its own row of its part's region, the parts back to back."""
    slots = []
    for p, (c0, w) in enumerate(_parts(hd)):
        span, region = 2 * w, rows * 128 * p  # Cols::offset
        r, c = np.meshgrid(np.arange(rows), np.arange(0, w, 8), indexing="ij")
        a = _tma(region, span, r, c)
        assert (a % 16 == 0).all()
        assert ((a >= region + r * span) & (a < region + (r + 1) * span)).all()
        slots.append(a.ravel())
    slots = np.concatenate(slots)
    assert len(np.unique(slots)) == slots.size == rows * hd // 8
    assert slots.max() + 16 == rows * hd * 2  # the tile's bytes, no gap


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("nwg", [1, 2])
def test_qk_descriptors_read_what_tma_wrote(hd, nwg):
    """S = Q K^T: each consumer warpgroup's A descriptors (its 64 rows of
    Q, part by part, a k-step 32 bytes further inside the swizzle atom) and
    the B descriptors (the stage's K tile) reach element (row, 16 kk + k)
    where TMA stored it, for every k-step of every part."""
    rows, keys, q_bytes, _, _, _ = _geo(hd, nwg)
    q_base, k_base = 0, q_bytes  # Q at the base, stage 0's K tile after it
    r, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    n, kn = np.meshgrid(np.arange(keys), np.arange(16), indexing="ij")
    steps = 0
    for p, (c0, w) in enumerate(_parts(hd)):
        span = 2 * w
        q_region, k_region = q_base + rows * 128 * p, k_base + keys * 128 * p
        for cw in range(nwg):
            for kk in range(w // 16):
                qa = q_region + 64 * cw * span + 32 * kk
                _field(qa), _field(8 * span)
                assert (_kmajor(qa, 8 * span, span, r, k)
                        == _tma(q_region, span, 64 * cw + r, 16 * kk + k)).all()
                ka = k_region + 32 * kk
                assert (_kmajor(ka, 8 * span, span, n, kn)
                        == _tma(k_region, span, n, 16 * kk + kn)).all()
                steps += cw == 0
    assert steps == hd // 16  # every column of the head in exactly one k-step


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("nwg", [1, 2])
def test_pv_descriptors_read_v_transposed(hd, nwg):
    """acc += P V: the MN-major B descriptor of every 16-key step reaches
    element (key 16 kk + k, column n) of the stage's V tile where TMA
    stored it: one m64n128 over both parts at hd 128 (LBO steps to the
    second part), else one wgmma a part (n = 16, 32, 64; hd 80: 64 + 16)."""
    rows, keys, q_bytes, kv_bytes, _, _ = _geo(hd, nwg)
    v_base = q_bytes + kv_bytes  # stage 0's V tile
    for kk in range(keys // 16):
        if hd == 128:
            k, n = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
            start, lbo = v_base + 16 * kk * 128, keys * 128
            got = _mnmajor(start, _field(lbo) << 4, 1024, 128, k, n)
            want = _tma(v_base + keys * 128 * (n // 64), 128, 16 * kk + k, n % 64)
            assert (got == want).all()
            continue
        for p, (c0, w) in enumerate(_parts(hd)):
            span, region = 2 * w, v_base + keys * 128 * p
            k, n = np.meshgrid(np.arange(16), np.arange(w), indexing="ij")
            start = region + 16 * kk * span
            _field(start), _field(8 * span)
            got = _mnmajor(start, 16, 8 * span, span, k, n)
            assert (got == _tma(region, span, 16 * kk + k, n)).all()


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("nwg", [1, 2])
def test_block_fits_shared_memory_and_registers(hd, nwg):
    """Q, the stages of K and V, their barriers and the base's alignment
    within a block's 227 KB; a 64-query block leaves room for a second on
    the SM (its point); four stages but in hd 128's 64-query block (two);
    and the registers a thread can hold, with an SM's 65,536 in four
    files, one for each quarter of its warps (9 warps a block, or two
    blocks of 5: at most three a file, 168 registers each), hold a
    consumer's live set while P V runs (a tile's S, the accumulator, the
    previous tile's P in hi and lo) with 32 to spare; with the producer a
    whole warpgroup, the 64-query blocks (two of 8 warps) would not."""
    rows, keys, q_bytes, kv_bytes, stages, smem = _geo(hd, nwg)
    assert q_bytes % 1024 == 0 and kv_bytes % 1024 == 0  # every region on the swizzle's period
    assert smem <= SMEM_PER_BLOCK
    if nwg == 1:
        assert 2 * (smem + 1024) <= SMEM_PER_SM
    assert stages == (2 if (hd, nwg) == (128, 1) else 4)
    def cap(warps):  # registers a thread, ``warps`` an SM dealt over four files
        return min(255, 16_384 // (32 * -(-warps // 4)) // 8 * 8)

    blocks = 2 if nwg == 1 else 1
    live = keys // 2 + hd // 2 + keys // 2  # S, acc, P's hi and lo (bf16 pairs)
    assert cap(blocks * (4 * nwg + 1)) == 168 and cap(blocks * (4 * nwg + 1)) - live >= 32
    assert cap(blocks * 4 * (nwg + 1)) == (128 if nwg == 1 else 168)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_parts_cover_exactly_the_head_dim(hd):
    """The parts reach columns 0 .. hd - 1, each once, in boxes whose rows
    are 32, 64 or 128 bytes (TMA's swizzle spans); hd 80 is 64 + 16."""
    cols = [c for c0, w in _parts(hd) for c in range(c0, c0 + w)]
    assert cols == list(range(hd))
    assert all(2 * w in (32, 64, 128) for _, w in _parts(hd))
    if hd == 80:
        assert _parts(hd) == [(0, 64), (64, 16)]
