"""The chunked, double-buffered exchange of ``repro_torch.core.distributed_pb``
against ``repro.core.distributed_pb`` (mirrors
``tests/test_sharded_pipeline.py`` case for case).

The reference runs once, in a subprocess with 8 forced host devices; the
port runs in gloo groups of 1, 2, 4 and 8 spawned CPU ranks
(``torch_sharded_harness``), every rank on the same global inputs. Each
port case names the reference result it is held to: integer ops, min
and max are order-free, so every method and K is held exactly to the
reference's K = 1 result; float ``add`` at K to the reference's at K with
rtol 1e-5, atol 1e-6. CSRs, overflow info dicts (at 8 ranks, where they
are the reference's shapes) and packed-versus-unpacked results exactly.
The hypothesis leg of the reference becomes seeded grids here.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import distributed_pb as dpb
from torch_sharded_harness import WORLDS, as_json, loads, run_port, run_reference, save_rank

REDUCE_TOL = dict(rtol=1e-5, atol=1e-6)


def _cases():
    """Port cases ``(name, idx, val, out_size, op, method, K, packed,
    capacity, want, exact)`` and the reference cases ``want`` names
    ``(name, idx, val, out_size, op, K, packed, capacity)``."""
    port, ref = [], []
    for op in ("add", "min", "max"):
        ref.append((f"r_{op}_i", "ch_idx", "ch_i", 451, op, 1, True, None))
        for method in ("fused", "sort", "counting"):
            for K in (1, 2, 4):
                port.append((f"ch_{method}_{op}_i_K{K}", "ch_idx", "ch_i", 451, op, method, K,
                             True, None, f"r_{op}_i", True))
    for op in ("min", "max"):
        ref.append((f"r_{op}_f", "ch_idx", "ch_f", 451, op, 1, True, None))
        for method in ("fused", "sort", "counting"):
            for K in (1, 2, 4):
                port.append((f"ch_{method}_{op}_f_K{K}", "ch_idx", "ch_f", 451, op, method, K,
                             True, None, f"r_{op}_f", True))
    for K in (1, 2, 4):
        ref.append((f"r_add_f_K{K}", "ch_idx", "ch_f", 451, "add", K, True, None))
        for method in ("fused", "sort", "counting"):
            port.append((f"ch_{method}_add_f_K{K}", "ch_idx", "ch_f", 451, "add", method, K,
                         True, None, f"r_add_f_K{K}", False))
    ref.append(("r_rows_i", "ch_idx", "ch_rows", 451, "add", 1, True, None))
    for K in (1, 2, 4):
        port.append((f"rows_i_K{K}", "ch_idx", "ch_rows", 451, "add", "fused", K, True, None,
                     "r_rows_i", True))
    # K > m_local clamps to the chunk layout
    ref.append(("r_tiny", "tiny_idx", "tiny_val", 5, "add", 4, True, None))
    port.append(("tiny_K4", "tiny_idx", "tiny_val", 5, "add", "fused", 4, True, None, "r_tiny",
                 True))
    # packed (one int32 buffer) against two collectives
    for tag, vk, op, exact in (("f_add", "pk_f", "add", False), ("f_min", "pk_f2", "min", True),
                               ("i_add", "pk_i", "add", True), ("rows_max", "pk_rows", "max", True),
                               ("i16_add", "pk_i16", "add", True)):
        ref.append((f"r_pk_{tag}", "pk_idx", vk, 333, op, 1, True, None))
        for K in (1, 2):
            for packed in (True, False):
                port.append((f"pk_{tag}_K{K}_{packed}", "pk_idx", vk, 333, op, "fused", K, packed,
                             None, f"r_pk_{tag}", exact or K == 1))
    # adversarial skew: every tuple to rank 0, capacity 8 overflows
    ref.append(("r_skew_est", "sk_idx", "sk_val", 800, "add", None, True, None))
    for K in (1, 2, 4):
        ref.append((f"r_skew_K{K}", "sk_idx", "sk_val", 800, "add", K, True, 8))
        port.append((f"skew_K{K}", "sk_idx", "sk_val", 800, "add", "fused", K, True, 8,
                     f"r_skew_K{K}", True))
    port.append(("skew_est", "sk_idx", "sk_val", 800, "add", "fused", None, True, None,
                 "r_skew_est", True))
    return port, ref


PORT_CASES, REF_CASES = _cases()
CSR_KS = (1, 2, 4)


def _write_inputs(workdir):
    rng = np.random.default_rng(42)
    m, n = 1733, 451  # non-divisible by 8 on both axes
    d = {
        "ch_idx": rng.integers(0, n, m).astype(np.int32),
        "ch_i": rng.integers(-50, 50, m).astype(np.int32),
        "ch_f": rng.standard_normal(m).astype(np.float32),
        "ch_rows": rng.integers(-9, 9, (m, 3)).astype(np.int32),
        "tiny_idx": np.array([3, 1, 3, 0], np.int32),
        "tiny_val": np.array([1, 2, 3, 4], np.int32),
    }
    rng = np.random.default_rng(11)
    m = 1999
    d["pk_idx"] = rng.integers(0, 333, m).astype(np.int32)
    d["pk_f"] = rng.standard_normal(m).astype(np.float32)
    d["pk_f2"] = rng.standard_normal(m).astype(np.float32)
    d["pk_i"] = rng.integers(-99, 99, m).astype(np.int32)
    d["pk_rows"] = rng.standard_normal((m, 2)).astype(np.float32)
    d["pk_i16"] = rng.integers(0, 99, m).astype(np.int16)
    d["sk_idx"] = np.zeros(1600, np.int32)
    d["sk_val"] = (np.arange(1600) % 7).astype(np.int32)
    # CSR: vertex 0 owns a third of the edges and destinations repeat,
    # so any order scramble shows
    rng = np.random.default_rng(3)
    src = rng.integers(0, 97, 1201)
    src[: 1201 // 3] = 0
    d["csr_src"] = src.astype(np.int32)
    d["csr_dst"] = rng.integers(0, 7, 1201).astype(np.int32)
    rng = np.random.default_rng(5)
    d["ex_idx"] = rng.integers(0, 500, 4000).astype(np.int32)
    d["ex_val"] = rng.standard_normal(4000).astype(np.float32)
    d["port_cases"] = np.asarray(json.dumps(PORT_CASES))
    d["ref_cases"] = np.asarray(json.dumps(REF_CASES))
    np.savez(str(workdir / "inputs.npz"), **d)


REFERENCE = """
from repro.core import COO, PBExecutor, make_stream_mesh
from repro.core.distributed_pb import shard_build_csr, shard_reduce_stream_info

mesh = make_stream_mesh(8)
for name, ik, vk, n, op, K, packed, cap in json.loads(str(inputs["ref_cases"])):
    got, info = shard_reduce_stream_info(jnp.asarray(inputs[ik]), jnp.asarray(inputs[vk]),
                                         out_size=n, mesh=mesh, op=op, pipeline_chunks=K,
                                         packed=packed, capacity=cap)
    out[name] = np.asarray(got)
    save_json(name + ":info", info)
coo = COO(jnp.asarray(inputs["csr_src"]), jnp.asarray(inputs["csr_dst"]), 97)
for K in %(csr_ks)r:
    csr = shard_build_csr(coo, mesh=mesh, pipeline_chunks=K)
    out[f"csr_K{K}_offsets"], out[f"csr_K{K}_neighs"] = np.asarray(csr.offsets), np.asarray(csr.neighs)
ex = PBExecutor(cache_dir=os.path.abspath("ref_cache"))
ex.shard_reduce_stream(jnp.asarray(inputs["sk_idx"]), jnp.asarray(inputs["sk_val"]), out_size=800,
                       mesh=mesh, op="add", capacity=8)
save_json("ex_overflow", ex.decision_log[-1])
ex.shard_reduce_stream(jnp.asarray(inputs["ex_idx"]), jnp.asarray(inputs["ex_val"]), out_size=500,
                       mesh=mesh, op="add")
save_json("ex_plain", ex.decision_log[-1])
""" % {"csr_ks": CSR_KS}

EXCHANGE_KEYS = ("kind", "mesh", "pipeline_chunks", "capacity", "capacity_source", "overflow",
                 "packed")


def _run_cases(z, mesh, out, suffix=""):
    for name, ik, vk, n, op, method, K, packed, cap, _, _ in json.loads(str(z["port_cases"])):
        got, info = dpb.shard_reduce_stream_info(
            torch.from_numpy(z[ik]), torch.from_numpy(z[vk]), out_size=n, mesh=mesh, op=op,
            method=method, pipeline_chunks=K, packed=packed, capacity=cap)
        out[name + suffix] = got.numpy()
        out[name + suffix + ":info"] = as_json(info)


def _port_ranks(rank, world, workdir):
    import os

    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    mesh = T.make_stream_mesh(device="cpu")
    out = {}
    _run_cases(z, mesh, out)
    # the packed lanes under flush-to-zero: an index read as float32 is a
    # denormal, so any float arithmetic on the packed buffer would erase it
    torch.set_flush_denormal(True)
    try:
        _run_cases({**z, "port_cases": np.asarray(json.dumps(
            [c for c in json.loads(str(z["port_cases"])) if c[0].startswith("pk_")]))},
            mesh, out, ":ftz")
    finally:
        torch.set_flush_denormal(False)

    coo = T.COO(torch.from_numpy(z["csr_src"]), torch.from_numpy(z["csr_dst"]), 97)
    orc = T.build_csr_oracle(coo)
    for K in CSR_KS:
        for packed in (True, False):
            csr = dpb.shard_build_csr(coo, mesh=mesh, pipeline_chunks=K, packed=packed)
            out[f"csr_K{K}_{packed}_offsets"] = csr.offsets.numpy()
            out[f"csr_K{K}_{packed}_neighs"] = csr.neighs.numpy()
            out[f"csr_K{K}_{packed}_oracle"] = np.bool_(
                torch.equal(csr.offsets, orc.offsets) and torch.equal(csr.neighs, orc.neighs))

    # every rank shares one cache directory: only rank 0 writes it
    cache = os.path.join(workdir, f"cache_w{world}")
    ex = T.PBExecutor(cache_dir=cache)
    sk = torch.from_numpy(z["sk_idx"]), torch.from_numpy(z["sk_val"])
    out["ex_overflow_out"] = ex.shard_reduce_stream(*sk, out_size=800, mesh=mesh, op="add",
                                                    capacity=8).numpy()
    out["ex_overflow"] = as_json(ex.decision_log[-1])
    st = torch.from_numpy(z["ex_idx"]), torch.from_numpy(z["ex_val"])
    ex.shard_reduce_stream(*st, out_size=500, mesh=mesh, op="add")
    out["ex_plain"] = as_json(ex.decision_log[-1])
    # autotune: the measured K sweep, kept under the :pipeline key
    ex2 = T.PBExecutor(autotune=True, cache_dir=cache + "_tune")
    ex2.shard_reduce_stream(*st, out_size=500, mesh=mesh, op="add")
    out["tune_recs"] = as_json({k: v for k, v in ex2.cache.mem.items() if k.endswith(":pipeline")})
    out["tune_last"] = as_json(ex2.decision_log[-1])
    # and reloaded (no tuning) from the file rank 0 wrote
    ex3 = T.PBExecutor(cache_dir=cache + "_tune")
    ex3.shard_reduce_stream(*st, out_size=500, mesh=mesh, op="add")
    out["tune_reload"] = as_json(ex3.decision_log[-1])
    save_rank(workdir, world, rank, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("sharded_pipeline")
    _write_inputs(wd)
    ref = run_reference(REFERENCE, wd)
    return ref, run_port(_port_ranks, wd)


def _close(got, want, exact):
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **REDUCE_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c for c in PORT_CASES if c[0].startswith(("ch_", "rows_", "tiny"))],
                         ids=lambda c: c[0])
def test_chunked_equals_reference(runs, case, world):
    """The pipelined schedule is a schedule change only: every method and K
    equals the reference (K = 1 for order-free ops, the same K for float
    add), also on non-divisible sizes, row values and K > m_local."""
    ref, port = runs
    name, want, exact = case[0], case[9], case[10]
    _close(port[world][name], ref[want], exact)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ["f_add", "f_min", "i_add", "rows_max", "i16_add"])
def test_packed_exchange_matches_two_collectives(runs, tag, world):
    """One int32 buffer (values by ``.view``, the index in an extra lane)
    gives the two-collective result bit for bit, also under
    flush-to-zero; int16 cannot pack and takes two collectives."""
    ref, port = runs
    p = port[world]
    for K in (1, 2):
        a, b = p[f"pk_{tag}_K{K}_True"], p[f"pk_{tag}_K{K}_False"]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(p[f"pk_{tag}_K{K}_True:ftz"], a)
        np.testing.assert_array_equal(p[f"pk_{tag}_K{K}_False:ftz"], b)
        _close(a, ref[f"r_pk_{tag}"], tag != "f_add" or K == 1)
        if world > 1:
            assert loads(p[f"pk_{tag}_K{K}_True:info"])["packed"] == (tag != "i16_add")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("K", CSR_KS)
def test_shard_build_csr_chunk_order_stability(runs, K, world):
    """Neighbour order is Edgelist order within every vertex, across the
    chunk boundaries too: equal to the reference and the oracle at every
    K, packed or not."""
    ref, port = runs
    for packed in (True, False):
        for part in ("offsets", "neighs"):
            _close(port[world][f"csr_K{K}_{packed}_{part}"], ref[f"csr_K{K}_{part}"], True)
        assert port[world][f"csr_K{K}_{packed}_oracle"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("K", (1, 2, 4))
def test_overflow_adversarial_skew(runs, K, world):
    """A capacity that every rank's segment to rank 0 blows raises the
    flag, reruns at the always-safe capacity and returns the exact sum."""
    ref, port = runs
    name = f"skew_K{K}"
    _close(port[world][name], ref[f"r_skew_K{K}"], True)
    info = loads(port[world][name + ":info"])
    if world > 1:
        assert info["overflow"] and info["fallback"], info
        assert info["capacity"] == info["safe_capacity"], info
    if world == 8:
        assert info == loads(ref[f"r_skew_K{K}:info"])


@pytest.mark.parametrize("world", WORLDS)
def test_skew_estimator_picks_the_safe_capacity(runs, world):
    ref, port = runs
    _close(port[world]["skew_est"], ref["r_skew_est"], True)
    info = loads(port[world]["skew_est:info"])
    assert not info["overflow"]
    assert info["capacity"] == info["safe_capacity"]
    if world == 8:
        assert info == loads(ref["r_skew_est:info"])


@pytest.mark.parametrize("world", WORLDS)
def test_executor_logs_the_overflow_fallback(runs, world):
    ref, port = runs
    _close(port[world]["ex_overflow_out"], ref["r_skew_K1"], True)
    last = loads(port[world]["ex_overflow"])
    if world == 1:
        assert "mesh" not in last
        return
    assert last["overflow"] is True and last["capacity_source"] == "overflow-fallback"
    assert last["mesh"] == {"shard": world}
    if world == 8:
        want = loads(ref["ex_overflow"])
        assert {k: last[k] for k in EXCHANGE_KEYS} == {k: want[k] for k in EXCHANGE_KEYS}


@pytest.mark.parametrize("world", WORLDS)
def test_executor_pipeline_decision(runs, world):
    """decide() stamps K on the sharded decision, autotune measures the K
    sweep (each K's time the largest over the ranks) and keeps it under
    the :pipeline key, and a new executor reloads it from the file rank
    0 wrote."""
    ref, port = runs
    p = port[world]
    last = loads(p["ex_plain"])
    if world == 1:
        assert "mesh" not in last and loads(p["tune_recs"]) == {}
        return
    assert last["kind"] == "reduce" and last["mesh"] == {"shard": world}
    for key in ("pipeline_chunks", "capacity", "overflow", "packed", "capacity_source"):
        assert key in last, (key, last)
    assert last["pipeline_chunks"] >= 1 and last["capacity_source"] == "estimated"
    if world == 8:
        want = loads(ref["ex_plain"])
        assert {k: last[k] for k in EXCHANGE_KEYS} == {k: want[k] for k in EXCHANGE_KEYS}
    recs = loads(p["tune_recs"])
    assert len(recs) == 1, recs
    rec = next(iter(recs.values()))
    assert rec["pipeline_chunks"] in (1, 2, 4) and set(rec["timings_us"]) == {"1", "2", "4"}
    assert loads(p["tune_last"])["pipeline_chunks"] == rec["pipeline_chunks"]
    assert loads(p["tune_reload"])["pipeline_chunks"] == rec["pipeline_chunks"]


# -- in-process: topology-free invariants ----------------------------------------------


def test_chunk_layout_invariants():
    for m_local in (0, 1, 2, 3, 7, 8, 100, 1001):
        for chunks in (1, 2, 3, 4, 8, 1000):
            k, chunk_len = dpb._chunk_layout(m_local, chunks)
            assert 1 <= k <= max(1, m_local) and k <= chunks
            assert k * chunk_len >= m_local and chunk_len >= 1


def test_chunk_layout_covers_stream_seeded_grid():
    """The reference's hypothesis property over 200 seeded draws: the
    chunks cover the stream and never double it."""
    rng = np.random.default_rng(0)
    for m_local, chunks in zip(rng.integers(0, 10_001, 200), rng.integers(1, 65, 200)):
        k, chunk_len = dpb._chunk_layout(int(m_local), int(chunks))
        assert 1 <= k <= max(1, m_local) and k <= chunks
        assert m_local <= k * chunk_len <= 2 * max(1, m_local)


def test_estimate_capacity_bounds():
    n, n_dev = 4096, 8
    rng = np.random.default_rng(0)
    uniform = rng.integers(0, n, 1 << 14)
    skewed = np.zeros(1 << 14, dtype=np.int64)
    for chunks in (1, 2, 4):
        chunk_len = -(-(-(-uniform.shape[0] // n_dev)) // chunks)
        cap_u = dpb.estimate_capacity(uniform, out_size=n, n_dev=n_dev, chunks=chunks)
        cap_s = dpb.estimate_capacity(skewed, out_size=n, n_dev=n_dev, chunks=chunks)
        assert 1 <= cap_u < chunk_len // 2
        assert cap_s == chunk_len
    assert dpb.estimate_capacity(np.zeros(0, np.int64), out_size=n, n_dev=n_dev) == 1
    assert dpb.estimate_capacity(uniform, out_size=n, n_dev=1) == 1
    with_sentinels = np.concatenate([uniform, np.full(100, n)])
    cap = dpb.estimate_capacity(with_sentinels, out_size=n, n_dev=n_dev)
    assert 1 <= cap <= -(-with_sentinels.shape[0] // n_dev)
    # a tensor on the device samples like its numpy copy
    t = torch.from_numpy(uniform.astype(np.int32))
    assert dpb.estimate_capacity(t, out_size=n, n_dev=n_dev) == dpb.estimate_capacity(
        uniform, out_size=n, n_dev=n_dev)


def test_estimate_capacity_equals_reference_seeded_grid():
    """The reference's hypothesis property over seeded draws, and the
    port's estimate equal to the reference's on each."""
    from repro.core.distributed_pb import estimate_capacity as ref_estimate

    rng = np.random.default_rng(1)
    for _ in range(60):
        arr = rng.integers(0, 500, int(rng.integers(1, 2001))).astype(np.int64)
        n_dev, chunks = int(rng.choice([2, 4, 8])), int(rng.choice([1, 2, 4]))
        chunk_len = -(-(-(-arr.shape[0] // n_dev)) // chunks)
        cap = dpb.estimate_capacity(arr, out_size=500, n_dev=n_dev, chunks=chunks)
        assert cap == ref_estimate(arr, out_size=500, n_dev=n_dev, chunks=chunks)
        assert 1 <= cap <= chunk_len
        assert dpb.estimate_capacity(np.zeros_like(arr), out_size=500, n_dev=n_dev,
                                     chunks=chunks) == chunk_len


def test_overlap_model_properties():
    from repro_torch.roofline import ShardedPBStreamRoofline

    big = ShardedPBStreamRoofline(num_tuples=1 << 28, num_indices=1 << 24, n_dev=8)
    tiny = ShardedPBStreamRoofline(num_tuples=1 << 10, num_indices=1 << 8, n_dev=8)
    for rl in (big, tiny):
        assert rl.t_pipelined(1) == rl.t_sequential
        prev = rl.t_sequential
        for k in (2, 4, 8):
            t = rl.t_pipelined(k)
            assert rl.t_step <= t <= prev + 1e-18
            prev = t
            assert 1.0 <= rl.overlap_efficiency(k) <= 2.0
            assert 0.0 <= rl.hidden_exchange_fraction(k) <= 1.0
        assert rl.hidden_exchange_fraction(1) == 0.0
    assert tiny.best_pipeline_chunks() == 1
    assert big.best_pipeline_chunks() > 1
    assert big.t_step == max(big.t_hbm, big.t_ici)


def test_default_pipeline_chunks():
    assert dpb.default_pipeline_chunks(1 << 10, 1 << 8, 8) == 1  # tiny: K = 1
    assert dpb.default_pipeline_chunks(1 << 28, 1 << 24, 8) > 1
    assert dpb.default_pipeline_chunks(1 << 28, 1 << 24, 1) == 1  # one rank
    assert dpb.default_pipeline_chunks(0, 1 << 8, 8) == 1


def test_traffic_chunk_counters():
    from repro_torch.core import traffic

    m, n_dev = 1 << 20, 8
    mono = traffic.sharded_exchange_bytes_per_device(m, n_dev)
    for k in (1, 2, 4):
        per_chunk = traffic.sharded_exchange_chunk_bytes_per_device(m, n_dev, k)
        total = traffic.sharded_pipelined_exchange_bytes_per_device(m, n_dev, k)
        assert total == pytest.approx(k * per_chunk) and total == pytest.approx(mono)
    cap = -(-(m // n_dev) // 4) // n_dev + 1
    padded = traffic.sharded_pipelined_exchange_bytes_per_device(m, n_dev, 4, padded_capacity=cap)
    assert padded >= traffic.sharded_pipelined_exchange_bytes_per_device(m, n_dev, 4)
    assert traffic.sharded_exchange_chunk_bytes_per_device(m, 1, 4) == 0.0
    assert traffic.exchange_collective_launches(4, packed=True) == 4
    assert traffic.exchange_collective_launches(4, packed=False) == 8
    assert traffic.exchange_collective_launches(1, packed=True) == 1


def test_padding_helpers_equal_the_reference():
    """``_pad_to_multiple`` as the reference's (sentinel fill, rows too);
    a rank's block is its slice of the padded stream."""
    import jax.numpy as jnp

    from repro.core.distributed_pb import _pad_to_multiple as ref_pad

    rng = np.random.default_rng(2)
    for m, mult in ((0, 4), (1, 4), (7, 4), (8, 4), (9, 8)):
        for shape in ((m,), (m, 3)):
            x = rng.integers(0, 9, shape).astype(np.int32)
            want = np.asarray(ref_pad(jnp.asarray(x), mult, 5))
            got = dpb._pad_to_multiple(torch.from_numpy(x), mult, 5).numpy()
            np.testing.assert_array_equal(got, want)
            if m:
                per = -(-m // mult)
                for r in range(mult):
                    np.testing.assert_array_equal(
                        dpb._rank_block(torch.from_numpy(x), r, per, 5).numpy(),
                        np.asarray(ref_pad(jnp.asarray(x), mult * per, 5))[r * per:(r + 1) * per])
