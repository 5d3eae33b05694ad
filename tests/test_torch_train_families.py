"""Training of the moe, ssm and hybrid families on the CPU against the JAX
package: ``qwen3-moe-235b-a22b``, ``xlstm-350m`` and ``zamba2-2.7b``
reduced (float32; 2 MoE layers of 8 experts, top-2; 2 xLSTM cycles; 2
Zamba2 cycles of 2 Mamba2 blocks and the shared block), from the
reference's weights (``lm_params_from_numpy``) and optimizer state
(``train_state_from_numpy``), on numpy batches of B 2 x S 40: ragged
against the recurrent chunk (16) and the attention block (32), and a loss
chunk of 24.

- The loss (rtol 1e-5) and every gradient against ``jax.value_and_grad``
  of the reference's loss, each within ``GRAD_TOL[arch]`` of its tensor's
  max |g|.
- Three steps of AdamW and of Adafactor against the reference's jitted
  step, each from the reference's state before it: loss, lr and grad norm,
  the moments within ``GRAD_TOL[arch]`` of their max (Adafactor's on the
  reference's stacked leaves: two-level for the hybrid's Mamba2 blocks,
  (L, E, d, f) for the experts), parameters within 2 lr_t + 1e-6 (see
  ``tests/test_torch_train_step.py``); and the port's own chain of the
  three steps, its losses within rtol 1e-5 of the reference's (xLSTM
  1e-4: AdamW's first step moves an element whose gradient is rounding
  noise by lr in either sign, and the next gradient, taken at those
  parameters, passes through the conditioning below; measured 2.2e-5).
- Accumulation over 2 microbatches equals the full batch; remat on equals
  remat off, and with remat each cycle runs twice.
- The launcher (``--preset smoke --device cpu``) runs two steps of each
  family, saves, restores bit for bit and resumes; an Adafactor state
  (two-level and expert-stacked moments) saves and restores bit for bit.

Tolerances. The moe family holds the default 1e-5. The recurrent families
need more, and it is the reference's own float32 conditioning, not a
difference of function: their losses agree to 1.5e-7 and each recurrent
layer's gradients, alone, to 3e-6 (mLSTM aside). xLSTM's mLSTM divides by
its normalizer |q . n|, which crosses zero at some positions; there one
float32 ulp in the projections moves the output by orders of magnitude
more than elsewhere (the reference alone moves its layer output by up to
4.2e-5 of max |out| when its input is perturbed by one ulp; the two
packages' matrix products round differently, and differ by 3.4e-4 at the
same input). Through two cycles the xLSTM model's gradients differ by up
to 1.4e-4 of max |g| at this batch (measured worst; 1.4e-4 to 3.7e-4 over
batch seeds 0-3, every leaf's median 1.5e-5 to 1e-4), so ``GRAD_TOL`` is
4e-4 there. A float64 witness shows that this is the reference's own
float32 error and not a defect of the port: the reference run in float64
(its float32 casts promoted, ``jax.enable_x64``) on the same weights and
batches is the true gradient; over batch seeds 0-3 the reference's
float32 gradients lie up to 3.7e-4 of max |g| from it, the port's up to
2.2e-4, and no leaf of the port lies farther than 1.07 times the
reference's worst distance on that leaf
(``test_xlstm_float32_gradients_are_as_close_to_float64_as_the_reference``).
No float32 implementation can then be held to the reference within 1e-4
at every batch. Zamba2's Mamba2 chain (softplus, decays, the gated RMSNorm)
amplifies less: 2.5e-5 at this batch (1.1e-5 to 4.5e-5 over seeds 0-3,
the reference itself moving by up to 5.3e-5 between its chunk widths 8 and
16), so 6e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.params import unbox
from repro.train import optimizer as RO
from repro.train import steps as RS
from repro_torch.checkpoint.manager import CheckpointManager, _flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.launch import train as train_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import steps as S
from repro_torch.train.optimizer import reference_leaf

ARCHS = ["qwen3-moe-235b-a22b", "xlstm-350m", "zamba2-2.7b"]
B, SEQ = 2, 40
CFG_KW = dict(loss_chunk=24)
OC_KW = dict(warmup_steps=2, total_steps=20)
LOSS_RTOL = 1e-5
GRAD_TOL = {"qwen3-moe-235b-a22b": 1e-5, "xlstm-350m": 4e-4, "zamba2-2.7b": 6e-5}
# the float64 witness (docstring): batch seeds, and how much farther than the
# reference's float32 gradients a leaf of the port's may lie from the float64 one
WITNESS_SEEDS = (0, 1, 2, 3)
WITNESS_LEAF_RATIO = 1.5  # measured at most 1.07 (the embedding and ln_m.w of cycle 0)
CHAIN_LOSS_RTOL = {"xlstm-350m": 1e-4}  # the chained steps' losses (docstring)


def _ref_leaf(tree, name):
    key, index = reference_leaf(name)
    node = tree
    for k in key.split("."):
        node = node[k]
    node = np.asarray(node, dtype=np.float32)
    return node if index is None else node[index]


def _close_scaled(got, want, tol, what=""):
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(B, SEQ)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(B, SEQ)).astype(np.int32)
    labels[1, :7] = -1
    return {"tokens": tokens, "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    rcfg = ref_get_config(arch).reduced(**CFG_KW)
    cfg = get_config(arch).reduced(**CFG_KW)
    rparams = jax.jit(lambda key: unbox(RT.init_params(key, rcfg))[0])(jax.random.PRNGKey(0))
    return arch, rcfg, cfg, rparams


def _states(setup, kind, cfg=None):
    _, rcfg, cfg0, rparams = setup
    cfg = cfg or cfg0
    roc = RO.OptConfig(kind=kind, **OC_KW)
    oc = O.OptConfig(kind=kind, **OC_KW)
    rstate = RS.TrainState(rparams, RO.init_opt_state(rparams, roc))
    state = train_state_from_numpy(jax.tree.map(np.asarray, rparams),
                                   jax.tree.map(np.asarray, rstate.opt), cfg, device="cpu")
    return rstate, roc, state, oc


def _ref_loss_fn(rcfg):
    def loss_fn(params, batch):
        hidden, _ = RT.hidden_forward(params, batch["tokens"], rcfg)
        return RT.chunked_lm_loss(params, hidden, batch["labels"], rcfg, chunk=rcfg.loss_chunk)
    return loss_fn


def _check_moments(state, rstate, tol, what):
    opt, ropt = state.opt, rstate.opt
    assert opt.step == int(ropt.step)
    if opt.m is not None:
        for n in opt.m:
            _close_scaled(opt.m[n], _ref_leaf(ropt.m, n), tol, f"{what}: m {n}")
            _close_scaled(opt.v[n], _ref_leaf(ropt.v, n), tol, f"{what}: v {n}")
        return
    for key, v in opt.v.items():
        node = ropt.v
        for k in key.split("."):
            node = node[k]
        node = node if isinstance(node, tuple) else (node,)
        got = v if isinstance(v, tuple) else (v,)
        assert len(got) == len(node), key
        for a, b in zip(got, node):
            assert tuple(a.shape) == tuple(np.shape(b)), key
            _close_scaled(a, b, tol, f"{what}: v {key}")


def test_loss_and_every_gradient_equal_the_reference(setup, monkeypatch):
    arch, rcfg, cfg, rparams = setup
    batch = _batch(0, cfg.vocab_size)
    rloss, rgrads = jax.jit(jax.value_and_grad(_ref_loss_fn(rcfg)))(
        rparams, jax.tree.map(jnp.asarray, batch))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    ties, moe_apply = [], L.moe_apply

    def recording(p, x, c):  # top-k ties would route differently from the reference
        ties.append(L.moe_topk_ties(x.detach().reshape(-1, x.shape[-1]), p.wr.detach(), c))
        return moe_apply(p, x, c)

    monkeypatch.setattr(L, "moe_apply", recording)
    loss = S.make_loss_fn(cfg)(model, _tb(batch))
    assert ties == ([0] * cfg.num_layers if cfg.family == "moe" else [])
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=LOSS_RTOL)
    for n, g in zip(names, grads):
        _close_scaled(g, _ref_leaf(rgrads, n), GRAD_TOL[arch], n)


class _Float64:
    """``jax.numpy`` with its ``float32`` (and the loss's ``int32`` count)
    promoted, handed to the reference's model modules so that their
    explicit casts keep float64 under ``jax.enable_x64``."""
    float32 = jnp.float64
    int32 = jnp.int64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_xlstm_float32_gradients_are_as_close_to_float64_as_the_reference(monkeypatch):
    """The float64 witness behind xLSTM's ``GRAD_TOL`` (docstring): on each
    of WITNESS_SEEDS' batches, the distance of the port's float32 gradients
    from the reference's float64 ones, and that of the reference's float32
    gradients, each as a share of the float64 leaf's max |g|. Over the
    batches, the port's worst leaf lies no farther than the reference's
    worst leaf, and each leaf of the port within WITNESS_LEAF_RATIO of the
    reference's distance on that leaf."""
    from repro.models import layers as RL
    from repro.models import ssm as RSSM

    arch = "xlstm-350m"
    rcfg = ref_get_config(arch).reduced(**CFG_KW)
    cfg = get_config(arch).reduced(**CFG_KW)
    rparams = jax.jit(lambda key: unbox(RT.init_params(key, rcfg))[0])(jax.random.PRNGKey(0))
    p_np = jax.tree.map(np.asarray, rparams)
    model = lm_params_from_numpy(p_np, cfg, device="cpu")
    names, params = zip(*model.named_parameters())
    ref32 = jax.jit(jax.grad(_ref_loss_fn(rcfg)))
    cfg64 = dataclasses.replace(rcfg, param_dtype="float64", compute_dtype="float64")
    port_d, ref_d = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for seed in WITNESS_SEEDS:
        batch = _batch(seed, cfg.vocab_size)
        g32 = ref32(rparams, jax.tree.map(jnp.asarray, batch))
        with monkeypatch.context() as m, jax.enable_x64(True):
            for mod in (RT, RSSM, RL):
                m.setattr(mod, "jnp", _Float64())
            p64 = jax.tree.map(lambda a: jnp.asarray(a.astype(np.float64)), p_np)
            g64 = jax.tree.map(np.asarray, jax.grad(_ref_loss_fn(cfg64))(
                p64, jax.tree.map(jnp.asarray, batch)))
        assert {a.dtype for a in jax.tree.leaves(g64)} == {np.dtype(np.float64)}
        loss = S.make_loss_fn(cfg)(model, _tb(batch))
        for n, g in zip(names, torch.autograd.grad(loss, params)):
            key, index = reference_leaf(n)
            true = g64
            for k in key.split("."):
                true = true[k]
            true = true if index is None else true[index]
            scale = float(np.abs(true).max()) or 1.0
            port_d[n] = max(port_d[n], float(np.abs(g.double().numpy() - true).max()) / scale)
            ref_d[n] = max(ref_d[n], float(np.abs(
                _ref_leaf(g32, n).astype(np.float64) - true).max()) / scale)
    assert max(port_d.values()) <= max(ref_d.values()), (port_d, ref_d)
    for n in names:
        assert port_d[n] <= WITNESS_LEAF_RATIO * ref_d[n], (n, port_d[n], ref_d[n])


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_three_steps_equal_the_reference(setup, kind):
    """Each step from the reference's state before it (the moments carry
    the steps before), held to the reference's step; and the port's own
    chain of three steps, whose losses follow the reference's."""
    arch, rcfg, cfg, _ = setup
    rstate, roc, state, oc = _states(setup, kind)
    rstep = jax.jit(RS.make_train_step(rcfg, roc))
    step = S.make_train_step(cfg, oc)
    for i in range(3):
        batch = _batch(10 + i, cfg.vocab_size)
        synced = train_state_from_numpy(jax.tree.map(np.asarray, rstate.params),
                                        jax.tree.map(np.asarray, rstate.opt), cfg, device="cpu")
        rstate, rmet = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        one, met = step(synced, _tb(batch))
        state, chained = step(state, _tb(batch))
        what = f"{kind} step {i + 1}"
        assert met["lr"] == pytest.approx(float(rmet["lr"]), rel=1e-6)
        assert float(met["loss"]) == pytest.approx(float(rmet["loss"]), rel=LOSS_RTOL), what
        assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]),
                                                        rel=GRAD_TOL[arch]), what
        for n, p in one.params.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), _ref_leaf(rstate.params, n), rtol=0,
                                       atol=2 * met["lr"] + 1e-6, err_msg=f"{what}: {n}")
        _check_moments(one, rstate, GRAD_TOL[arch], what)
        assert float(chained["loss"]) == pytest.approx(
            float(rmet["loss"]), rel=CHAIN_LOSS_RTOL.get(arch, LOSS_RTOL)), what


def test_accumulation_equals_the_full_batch(setup):
    arch, _, cfg, _ = setup
    # every label valid: the mean of the two microbatches' means is the
    # full batch's mean, and the summed gradients the full batch's
    batch = dict(_batch(20, cfg.vocab_size))
    batch["labels"] = np.abs(batch["labels"])
    out = {}
    for accum in (1, 2):
        _, _, st, oc = _states(setup, "adamw")
        out[accum] = S.make_train_step(cfg, oc, accum_steps=accum)(st, _tb(batch))
    (s1, m1), (s2, m2) = out[1], out[2]
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=LOSS_RTOL)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]), rel=LOSS_RTOL)
    for n in s1.opt.m:
        _close_scaled(s2.opt.m[n], s1.opt.m[n].numpy(), GRAD_TOL[arch], n)
    for (n, a), (_, b) in zip(s1.params.named_parameters(), s2.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0,
                                   atol=2 * m1["lr"] + 1e-6, err_msg=n)


def test_remat_on_equals_remat_off(setup, monkeypatch):
    _, _, cfg, _ = setup
    batch = _batch(30, cfg.vocab_size)
    out, calls = {}, []
    cycle = T._apply_cycle

    def counted(*a, **kw):
        calls.append(1)
        return cycle(*a, **kw)

    monkeypatch.setattr(T, "_apply_cycle", counted)
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        _, _, state, oc = _states(setup, "adamw", cfg=c)
        calls.clear()
        state, met = S.make_train_step(c, oc)(state, _tb(batch))
        # with remat each cycle runs again in the backward
        assert len(calls) == T._num_cycles(c) * (2 if remat else 1)
        out[remat] = (float(met["loss"]), float(met["grad_norm"]), state)
    (l_on, g_on, s_on), (l_off, g_off, s_off) = out[True], out[False]
    # the same float32 operations recomputed: the same step
    assert l_on == pytest.approx(l_off, rel=LOSS_RTOL)
    assert g_on == pytest.approx(g_off, rel=LOSS_RTOL)
    for n in s_on.opt.m:
        _close_scaled(s_on.opt.m[n], s_off.opt.m[n].numpy(), 1e-5, n)
    lr = met["lr"]
    for (n, a), (_, b) in zip(s_on.params.named_parameters(), s_off.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0,
                                   atol=2 * lr + 1e-6, err_msg=n)


def test_launcher_trains_saves_restores_and_resumes(setup, tmp_path):
    arch, _, cfg, _ = setup
    flags = ["--arch", arch, "--preset", "smoke", "--device", "cpu", "--seq-len", "24",
             "--batch", "2", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    run = train_mod.train(train_mod.parse_args(flags + ["--steps", "2", "--ckpt-every", "1"]))
    assert len(run.losses) == 2 and all(np.isfinite(run.losses + run.grad_norms))
    opt = run.state.opt
    assert opt.step == 2 and opt.m is not None  # default_opt_config: AdamW at this size
    assert all(float(m.abs().max()) > 0 for m in opt.m.values())
    restored, at = CheckpointManager(str(tmp_path)).restore(run.state)
    assert at == 2
    pairs = list(zip(_flatten_with_paths(restored), _flatten_with_paths(run.state)))
    assert len(pairs) == len(list(_flatten_with_paths(run.state)))
    for (pa, a), (pb, b) in pairs:
        assert pa == pb
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, pa
    resumed = train_mod.train(train_mod.parse_args(flags + ["--steps", "3", "--ckpt-every", "5"]))
    assert resumed.start_step == 2 and len(resumed.losses) == 1
    assert np.isfinite(resumed.losses[0]) and resumed.state.opt.step == 3


def test_adafactor_state_saves_and_restores_bit_for_bit(setup, tmp_path):
    """A train state under Adafactor (factored moments keyed by the
    reference's leaves: two-level for the hybrid's Mamba2 blocks, stacked
    (L, E, ...) for the experts) after one step, saved and restored by
    ``CheckpointManager``: every leaf equal, bit for bit, by path."""
    _, _, cfg, _ = setup
    _, _, state, oc = _states(setup, "adafactor")
    state, _ = S.make_train_step(cfg, oc)(state, _tb(_batch(40, cfg.vocab_size)))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, state, blocking=True)
    _, _, fresh, _ = _states(setup, "adafactor")
    restored, at = ckpt.restore(fresh)
    assert at == 1
    got, want = list(_flatten_with_paths(restored)), list(_flatten_with_paths(state))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any("/v/blocks." in p for p, _ in want)
    for (path, a), (_, b) in zip(got, want):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, path
