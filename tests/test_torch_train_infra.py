"""The training slice's host-side pieces on the CPU against the JAX
package: the synthetic data (bit for bit), the scatter-add primitives,
the checkpoint manager (mirroring ``tests/test_training.py:94-145``),
the fault-tolerance helpers, and the launcher end to end with a resume.

``pb_scatter_add`` sums each run of equal indices as a difference of
float32 cumulative sums: against the reference (another summation order)
it is held to 1e-5 of the sum of |v| over the whole stream plus 1e-6,
the scale of a cumulative sum's rounding; the plain scatter to 1e-6 of
the per-index sum of |v| (a few terms in another order).
"""
import json
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scatter as RSC
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.ft import resilience as RFT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.core.scatter import pb_scatter_add, scatter_add_baseline
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_data
from repro_torch.ft import resilience as FT
from repro_torch.train import steps as S
from repro_torch.train.optimizer import OptConfig


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(seed=7, vocab_size=1000, seq_len=16, global_batch=4),
                                dict(seed=1234, vocab_size=151936, seq_len=33, global_batch=6,
                                     host_index=1, host_count=3, markov_order=3)])
def test_synthetic_batches_equal_the_reference_bit_for_bit(kw):
    mine, ref = SyntheticLM(DataConfig(**kw)), RSyntheticLM(RDataConfig(**kw))
    assert mine.local_batch == ref.local_batch
    for step in (0, 1, 123, 10**6):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    a = mine.batch_at(5)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not np.array_equal(a["tokens"], mine.batch_at(6)["tokens"])
    it = iter(mine)
    np.testing.assert_array_equal(next(it)["tokens"], mine.batch_at(0)["tokens"])


def test_make_data_follows_the_config_and_shape():
    cfg = get_config("qwen2-1.5b")
    d = make_data(cfg, ShapeSpec("t", 64, 8, "train"), seed=3, host_count=2)
    assert d.dc.vocab_size == cfg.vocab_size and d.local_batch == 4
    assert d.batch_at(0)["tokens"].shape == (4, 64)
    with pytest.raises(ValueError, match="split"):
        SyntheticLM(DataConfig(global_batch=5, host_count=2))


# ---------------------------------------------------------------------------
# scatter-add primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("shape", [(300,), (300, 5)])
def test_pb_scatter_add_equals_the_reference(coalesce, shape):
    rng = np.random.default_rng(len(shape) + 2 * coalesce)
    n = 41
    idx = np.minimum((rng.pareto(1.0, shape[0]) * 3).astype(np.int32), n - 1)
    idx[:5] = n - 1
    upd = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(RSC.pb_scatter_add(jnp.asarray(idx), jnp.asarray(upd), n, coalesce=coalesce))
    got = pb_scatter_add(torch.from_numpy(idx), torch.from_numpy(upd), n, coalesce=coalesce)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,) + shape[1:]
    tol = 1e-5 * np.abs(upd).sum(0) + 1e-6
    assert (np.abs(got.numpy() - want) <= tol).all()
    base = scatter_add_baseline(torch.from_numpy(idx), torch.from_numpy(upd), n)
    want_b = np.asarray(RSC.scatter_add_baseline(jnp.asarray(idx), jnp.asarray(upd), n))
    scale = np.zeros((n,) + shape[1:], np.float32)
    np.add.at(scale, idx, np.abs(upd))
    assert (np.abs(base.numpy() - want_b) <= 1e-6 * scale + 1e-7).all()


def test_scatter_add_follows_jnp_index_rules_and_dtypes():
    idx = np.array([3, -1, 7, 0, 3], np.int32)  # -1 counts from the end; 7 is dropped
    upd = np.arange(1, 6, dtype=np.float32)
    want = np.asarray(RSC.scatter_add_baseline(jnp.asarray(idx), jnp.asarray(upd), 5))
    got = scatter_add_baseline(torch.from_numpy(idx), torch.from_numpy(upd), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    bf = torch.from_numpy(upd).to(torch.bfloat16)
    ok = torch.tensor([3, 1, 1, 0, 3], dtype=torch.int32)
    out = pb_scatter_add(ok, bf, 5)
    assert out.dtype == torch.bfloat16 and out.tolist() == [4.0, 5.0, 0.0, 6.0, 0.0]
    assert pb_scatter_add(ok[:0], bf[:0], 3).tolist() == [0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _small_state(seed=0, kind="adamw"):
    cfg = get_config("qwen2-1.5b").reduced(param_dtype="bfloat16")
    state = S.make_init_fn(cfg, OptConfig(kind=kind, warmup_steps=2))(seed=seed, device="cpu")
    batch = S.make_batch(cfg, ShapeSpec("t", 16, 2, "train"), torch.Generator().manual_seed(seed))
    step = S.make_train_step(cfg, OptConfig(kind=kind, warmup_steps=2))
    state, _ = step(state, batch)
    return cfg, state, step, batch


def _leaves(state):
    from repro_torch.checkpoint.manager import _flatten_with_paths

    return list(_flatten_with_paths(state))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_checkpoint_roundtrip_is_bit_exact_and_resumes(kind):
    cfg, state, step, batch = _small_state(kind=kind)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep_n=2)
        cm.save(1, state, blocking=True)
        manifest = json.load(open(os.path.join(d, "step_0000000001", "manifest.json")))
        paths = [m["path"] for m in manifest["leaves"].values()]
        assert paths[0] == "params/embed.table" and "opt/step" in paths
        assert {m["dtype"] for m in manifest["leaves"].values()} >= {"bfloat16", "float32"}
        state2, at = cm.restore(state)
        assert at == 1 and state2.opt.step == state.opt.step == 1
        assert state2.params is not state.params
        for (pa, a), (pb, b) in zip(_leaves(state), _leaves(state2)):
            assert pa == pb
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8),
                                                          b.view(-1).view(torch.uint8)), pa
            else:
                assert a == b
        # continue from the restored state: the same next step
        s_a, m_a = step(state, batch)
        s_b, m_b = step(state2, batch)
        assert float(m_a["loss"]) == float(m_b["loss"])
        for (_, a), (_, b) in zip(_leaves(s_a), _leaves(s_b)):
            assert (a == b) if not isinstance(a, torch.Tensor) else torch.equal(a, b)


def test_checkpoint_detects_corruption_and_falls_back(capsys):
    tree = {"w": torch.arange(10, dtype=torch.float32), "n": 3}
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep_n=5)
        cm.save(1, tree, blocking=True)
        cm.save(2, {"w": tree["w"] + 1, "n": 4}, blocking=True)
        path = os.path.join(d, "step_0000000002", "shard-0.npz")
        np.savez(path, leaf_00000=np.zeros(10, np.float32), leaf_00001=np.asarray(4))
        restored, at = cm.restore(tree)
        assert at == 1 and restored["n"] == 3
        assert torch.equal(restored["w"], tree["w"])
        assert "step 2 unusable" in capsys.readouterr().out
        # a torn write: the manifest of step 1 cut short
        with open(os.path.join(d, "step_0000000001", "manifest.json"), "w") as f:
            f.write('{"step": 1, "lea')
        assert cm.restore(tree) == (None, None)
        cm.save(3, {"v": tree["w"]}, blocking=True)  # another tree's leaves
        with pytest.raises(ValueError, match="leaves"):
            cm.restore(tree)


def test_checkpoint_keep_n_gc_and_async_overlap():
    tree = {"w": torch.ones(4)}
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep_n=2)
        for s in (1, 2, 3, 4):
            cm.save(s, tree, blocking=True)
        assert cm.all_steps() == [3, 4] and cm.latest_step() == 4
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        cm.save(1, {"w": torch.ones(256, 256)}, blocking=False)  # returns at once
        cm.save(2, {"w": torch.zeros(256, 256)}, blocking=False)  # waits for step 1
        cm.wait()
        assert cm.all_steps() == [1, 2]
        restored, at = cm.restore({"w": torch.empty(256, 256)})
        assert at == 2 and float(restored["w"].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------


def test_straggler_detector_and_elastic_plan_equal_the_reference():
    rng = np.random.default_rng(4)
    mine, ref = FT.StragglerDetector(patience=3), RFT.StragglerDetector(patience=3)
    for t in range(40):
        for h in range(4):
            dt = 1.0 + 0.01 * rng.normal() + (3.0 if h == 2 and t > 20 else 0.0)
            assert mine.observe(f"h{h}", dt) == ref.observe(f"h{h}", dt)
    assert mine.flagged() == ref.flagged() == ["h2"]
    for old_d, old_m, surv in ((8, 4, 24), (4, 2, 7), (2, 8, 16)):
        a, b = FT.ElasticPlan(old_d, old_m, surv), RFT.ElasticPlan(old_d, old_m, surv)
        assert a.mesh_shape() == b.mesh_shape()
        assert a.accumulation_steps(3) == b.accumulation_steps(3)
    with pytest.raises(RuntimeError):
        FT.ElasticPlan(4, 8, 4)


def test_heartbeat_fires_when_the_loop_stops_beating():
    fired = []
    hb = FT.Heartbeat(timeout_s=0.2, on_timeout=lambda: fired.append(1)).start()
    hb.beat()
    hb._thread.join(timeout=5)
    assert not hb._thread.is_alive() and hb.fired and fired == [1]
    quiet = FT.Heartbeat(timeout_s=30).start()
    quiet.stop()
    quiet._thread.join(timeout=5)
    assert not quiet._thread.is_alive() and not quiet.fired


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_train_launcher_end_to_end_with_resume(capsys):
    from repro_torch.launch import train as train_mod

    common = ["--arch", "qwen2-1.5b", "--preset", "smoke", "--mesh", "none",
              "--seq-len", "32", "--batch", "4", "--log-every", "2", "--device", "cpu"]
    with tempfile.TemporaryDirectory() as d:
        run = train_mod.train(train_mod.parse_args(
            common + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "3"]))
        assert run.start_step == 0 and len(run.losses) == 6
        assert all(np.isfinite(run.losses)) and all(np.isfinite(run.grad_norms))
        assert run.state.opt.step == 6 and CheckpointManager(d).all_steps() == [3, 6]
        # resume: from step 6's checkpoint, two more steps
        resumed = train_mod.train(train_mod.parse_args(
            common + ["--steps", "8", "--ckpt-dir", d, "--ckpt-every", "4"]))
        assert resumed.start_step == 6 and len(resumed.losses) == 2
        assert "resumed from step 6" in capsys.readouterr().out
        assert CheckpointManager(d).all_steps() == [3, 6, 8]
        # the resumed run equals an uninterrupted one: the data is a function
        # of the step and the state comes back bit for bit
        full = train_mod.train(train_mod.parse_args(common + ["--steps", "8"]))
        assert full.losses[6:] == resumed.losses
        for (pa, a), (_, b) in zip(_leaves(resumed.state), _leaves(full.state)):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, pa
        # main returns the last loss; with the checkpoint at --steps, nothing is left
        assert np.isnan(train_mod.main(common + ["--steps", "8", "--ckpt-dir", d]))
    # over a mesh: four spawned gloo ranks on the CPU give the one-device losses
    meshed = train_mod.train(train_mod.parse_args(common + ["--steps", "2", "--mesh", "host:2x2"]))
    assert meshed.state is None and meshed.start_step == 0
    np.testing.assert_allclose(meshed.losses, full.losses[:2], rtol=1e-5)


def test_hybrid_block_checkpoint_resumes_on_another_mesh():
    """zamba2 (its Mamba2 leaves stacked twice in the reference) saved in
    blocks after a step on 2x2 resumes on 1x2 with accumulation 2, and the
    two steps' losses are the one-device run's."""
    from repro_torch.launch import train as train_mod

    common = ["--arch", "zamba2-2.7b", "--preset", "smoke", "--seq-len", "32", "--batch", "4",
              "--device", "cpu", "--log-every", "1"]
    with tempfile.TemporaryDirectory() as d:
        first = train_mod.train(train_mod.parse_args(
            common + ["--steps", "1", "--mesh", "host:2x2", "--ckpt-dir", d]))
        assert CheckpointManager(d).all_steps() == [1]
        resumed = train_mod.train(train_mod.parse_args(
            common + ["--steps", "2", "--mesh", "host:1x2", "--accum", "2", "--ckpt-dir", d,
                      "--no-ckpt-final"]))
    assert resumed.start_step == 1 and len(resumed.losses) == 1
    one = train_mod.train(train_mod.parse_args(common + ["--steps", "2", "--no-ckpt-final"]))
    np.testing.assert_allclose(first.losses + resumed.losses, one.losses, rtol=1e-5)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-2.7b", "llama-3.2-vision-11b",
                                  "whisper-base"])
def test_launcher_refuses_a_mesh_for_the_recurrent_families(arch):
    """The launcher no longer refuses them: ``--mesh host:2x2`` trains the
    ssm, hybrid, vlm and encdec families on four spawned ranks with the
    one-device loss; ``prod`` still needs its 256 ranks."""
    from repro_torch.launch import train as train_mod

    common = ["--arch", arch, "--preset", "smoke", "--seq-len", "32", "--batch", "4",
              "--device", "cpu", "--steps", "1", "--no-ckpt-final"]
    meshed = train_mod.main(common + ["--mesh", "host:2x2"])
    assert np.isfinite(meshed)
    assert meshed == pytest.approx(train_mod.main(common), rel=1e-5)
    with pytest.raises(ValueError, match="256 ranks"):
        train_mod.main(common + ["--mesh", "prod"])
