"""Training of the vlm and encdec families on the CPU against the JAX
package: ``llama-3.2-vision-11b`` and ``whisper-base`` reduced (float32;
2 vlm cycles of one self layer and one cross layer over 16 image tokens
of width 4096; Whisper's 2 encoder layers over 32 frames and 2 decoder
layers), from the reference's weights (``lm_params_from_numpy``) and
optimizer state (``train_state_from_numpy``), on numpy batches of B 2 x
S 40 (above the attention block, 32) with a loss chunk of 24, and the
frontend inputs of ``batch_struct`` drawn from a seed.

- With the frontend input: the loss (rtol 1e-5) and every gradient
  against ``jax.value_and_grad`` of the reference's loss, each within
  1e-5 of its tensor's max |g|; three AdamW steps and one Adafactor step
  (on the reference's stacked leaves: the vlm's self layers stacked
  twice, ``enc_blocks`` and ``dec_blocks`` once) against the reference's
  jitted step, each from the reference's state before it, parameters
  within 2 lr_t + 1e-6 (``tests/test_torch_train_step.py``).
- Without it (the launcher's batches: ``SyntheticLM`` yields tokens and
  labels only), the cross layers and Whisper's encoder are skipped on
  both sides: their gradients are exactly zero in the reference and in
  the port (ROADMAP Queue 3), and the launcher trains them not at all.
- Accumulation over 2 microbatches (the frontend rows split with the
  tokens) equals the full batch; remat on equals remat off, each vlm
  cycle and Whisper decoder layer running twice with remat and the
  encoder once.
- ``train_state_from_numpy`` carries the reference's AdamW and Adafactor
  states across leaf for leaf.
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
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import steps as S
from repro_torch.train.optimizer import reference_leaf

ARCHS = ["llama-3.2-vision-11b", "whisper-base"]
B, SEQ = 2, 40
CFG_KW = dict(loss_chunk=24)
OC_KW = dict(warmup_steps=2, total_steps=20)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5


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


def _unreached(name):
    """Leaves a batch without the frontend input does not reach: the cross
    layers' attention and its norm, the vlm's ``img_proj``, Whisper's
    encoder."""
    return (".xattn." in name or ".lnx." in name or name == "img_proj"
            or name.startswith("enc_"))


def _batch(seed, cfg, frontend=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, SEQ)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, SEQ)).astype(np.int32)
    labels[1, :7] = -1
    out = {"tokens": tokens, "labels": labels}
    if frontend and cfg.family == "vlm":
        shape = (B, cfg.num_image_tokens, cfg.frontend_dim)
        out["img_embed"] = (rng.normal(size=shape) * 0.02).astype(np.float32)
    elif frontend:
        shape = (B, cfg.encoder_seq, cfg.d_model)
        out["enc_embed"] = (rng.normal(size=shape) * 0.02).astype(np.float32)
    return out


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
        hidden, _ = RT.hidden_forward(params, batch["tokens"], rcfg,
                                      img_embed=batch.get("img_embed"),
                                      enc_embed=batch.get("enc_embed"))
        return RT.chunked_lm_loss(params, hidden, batch["labels"], rcfg, chunk=rcfg.loss_chunk)
    return loss_fn


def _ref_v(ropt, key):
    node = ropt.v
    for k in key.split("."):
        node = node[k]
    return node if isinstance(node, tuple) else (node,)


def _check_moments(state, rstate, what):
    opt, ropt = state.opt, rstate.opt
    assert opt.step == int(ropt.step)
    if opt.m is not None:
        for n in opt.m:
            _close_scaled(opt.m[n], _ref_leaf(ropt.m, n), GRAD_TOL, f"{what}: m {n}")
            _close_scaled(opt.v[n], _ref_leaf(ropt.v, n), GRAD_TOL, f"{what}: v {n}")
        return
    for key, v in opt.v.items():
        node = _ref_v(ropt, key)
        got = v if isinstance(v, tuple) else (v,)
        assert len(got) == len(node), key
        for a, b in zip(got, node):
            assert tuple(a.shape) == tuple(np.shape(b)), key
            _close_scaled(a, b, GRAD_TOL, f"{what}: v {key}")


@pytest.mark.parametrize("frontend", [True, False], ids=["frontend", "no_frontend"])
def test_loss_and_every_gradient_equal_the_reference(setup, frontend):
    """Without the frontend input the unreached leaves' gradients are
    exactly zero on both sides (``materialize_grads``; the reference's
    ``jax.grad`` gives 0.0)."""
    _, rcfg, cfg, rparams = setup
    batch = _batch(0, cfg, frontend)
    rloss, rgrads = jax.jit(jax.value_and_grad(_ref_loss_fn(rcfg)))(
        rparams, jax.tree.map(jnp.asarray, batch))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    loss = S.make_loss_fn(cfg)(model, _tb(batch))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=LOSS_RTOL)
    zeros = 0
    for n, g in zip(names, grads):
        want = _ref_leaf(rgrads, n)
        if not frontend and _unreached(n):
            assert not want.any() and not g.any(), n
            zeros += 1
        else:
            assert np.abs(want).max() > 0, n
            _close_scaled(g, want, GRAD_TOL, n)
    assert (zeros > 0) == (not frontend)


def test_train_step_without_the_frontend_gives_zero_gradients(setup):
    """``make_train_step`` on a batch without the frontend input: the step
    runs (no error for the leaves the loss does not reach), their
    moments stay exactly zero, every other moment moves."""
    _, _, cfg, _ = setup
    _, _, state, oc = _states(setup, "adamw")
    state, met = S.make_train_step(cfg, oc)(state, _tb(_batch(3, cfg, frontend=False)))
    assert np.isfinite(float(met["loss"]))
    for n in state.opt.m:
        moved = float(state.opt.m[n].abs().max()) > 0 and float(state.opt.v[n].abs().max()) > 0
        assert moved != _unreached(n), n
        if _unreached(n):
            assert not state.opt.m[n].any() and not state.opt.v[n].any(), n


def test_three_adamw_steps_equal_the_reference(setup):
    """Each step from the reference's state before it (the moments carry
    the steps before), held to the reference's step; and the port's own
    chain of three steps, whose losses follow the reference's."""
    _, rcfg, cfg, _ = setup
    rstate, roc, state, oc = _states(setup, "adamw")
    rstep = jax.jit(RS.make_train_step(rcfg, roc))
    step = S.make_train_step(cfg, oc)
    for i in range(3):
        batch = _batch(10 + i, cfg)
        synced = train_state_from_numpy(jax.tree.map(np.asarray, rstate.params),
                                        jax.tree.map(np.asarray, rstate.opt), cfg, device="cpu")
        rstate, rmet = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        one, met = step(synced, _tb(batch))
        state, chained = step(state, _tb(batch))
        what = f"adamw step {i + 1}"
        assert met["lr"] == pytest.approx(float(rmet["lr"]), rel=1e-6)
        assert float(met["loss"]) == pytest.approx(float(rmet["loss"]), rel=LOSS_RTOL), what
        assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]),
                                                        rel=GRAD_TOL), what
        for n, p in one.params.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), _ref_leaf(rstate.params, n), rtol=0,
                                       atol=2 * met["lr"] + 1e-6, err_msg=f"{what}: {n}")
        _check_moments(one, rstate, what)
        assert float(chained["loss"]) == pytest.approx(float(rmet["loss"]), rel=LOSS_RTOL), what


def test_one_adafactor_step_equals_the_reference(setup):
    """Adafactor's factored moments on the reference's stacked leaves: the
    vlm's ``blocks.self.*`` (cycles, n_self, ...) and ``blocks.cross.*``
    (cycles, ...), Whisper's ``enc_blocks.*`` and ``dec_blocks.*``."""
    _, rcfg, cfg, _ = setup
    rstate, roc, state, oc = _states(setup, "adafactor")
    keys = {"vlm": {"blocks.self.attn.wq", "blocks.cross.xattn.wq", "img_proj"},
            "encdec": {"enc_blocks.attn.wq", "dec_blocks.xattn.wq", "enc_pos", "enc_ln.w"}}
    assert keys[cfg.family] <= set(state.opt.v)
    batch = _batch(5, cfg)
    rstate, rmet = jax.jit(RS.make_train_step(rcfg, roc))(rstate, jax.tree.map(jnp.asarray, batch))
    state, met = S.make_train_step(cfg, oc)(state, _tb(batch))
    assert float(met["loss"]) == pytest.approx(float(rmet["loss"]), rel=LOSS_RTOL)
    assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=GRAD_TOL)
    for n, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _ref_leaf(rstate.params, n), rtol=0,
                                   atol=2 * met["lr"] + 1e-6, err_msg=n)
    _check_moments(state, rstate, "adafactor step 1")
    if cfg.family == "vlm":  # twice stacked: (cycles, n_self) rows of a (cycles, n_self, d, f) leaf
        rows, cols = state.opt.v["blocks.self.mlp.w1"]
        nc, ns = T._num_cycles(cfg), cfg.cross_attn_every - 1
        assert rows.shape == (nc, ns, cfg.d_model) and cols.shape == (nc, ns, cfg.d_ff)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_state_from_numpy_carries_every_leaf(setup, kind):
    """After one reference step (nonzero moments), the converted state
    holds each reference leaf bit for bit: parameters and AdamW's moments
    per layer, Adafactor's stacked factors under the reference's keys."""
    _, rcfg, cfg, _ = setup
    rstate, roc, _, _ = _states(setup, kind)
    rstate, _ = jax.jit(RS.make_train_step(rcfg, roc))(
        rstate, jax.tree.map(jnp.asarray, _batch(7, cfg)))
    state = train_state_from_numpy(jax.tree.map(np.asarray, rstate.params),
                                   jax.tree.map(np.asarray, rstate.opt), cfg, device="cpu")
    assert state.opt.step == int(rstate.opt.step) == 1
    for n, p in state.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), _ref_leaf(rstate.params, n), err_msg=n)
    if kind == "adamw":
        for n in state.opt.m:
            np.testing.assert_array_equal(state.opt.m[n].numpy(), _ref_leaf(rstate.opt.m, n))
            np.testing.assert_array_equal(state.opt.v[n].numpy(), _ref_leaf(rstate.opt.v, n))
        return
    assert set(state.opt.v) == {reference_leaf(n)[0] for n, _ in state.params.named_parameters()}
    for key, v in state.opt.v.items():
        for a, b in zip(v if isinstance(v, tuple) else (v,), _ref_v(rstate.opt, key)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)


def test_accumulation_equals_the_full_batch(setup):
    _, _, cfg, _ = setup
    batch = dict(_batch(20, cfg))
    batch["labels"] = np.abs(batch["labels"])  # every label valid: the means add up
    out = {}
    for accum in (1, 2):
        _, _, st, oc = _states(setup, "adamw")
        out[accum] = S.make_train_step(cfg, oc, accum_steps=accum)(st, _tb(batch))
    (s1, m1), (s2, m2) = out[1], out[2]
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=LOSS_RTOL)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]), rel=LOSS_RTOL)
    for n in s1.opt.m:
        _close_scaled(s2.opt.m[n], s1.opt.m[n].numpy(), GRAD_TOL, n)
    for (n, a), (_, b) in zip(s1.params.named_parameters(), s2.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0,
                                   atol=2 * m1["lr"] + 1e-6, err_msg=n)


def test_remat_on_equals_remat_off(setup, monkeypatch):
    """With remat each vlm cycle (its self layers and its cross layer) and
    each Whisper decoder layer runs again in the backward; Whisper's
    encoder layers run once either way."""
    _, _, cfg, _ = setup
    batch = _batch(30, cfg)
    out, calls, enc_calls = {}, [], []
    cycle, layer = T._apply_cycle, T._apply_dense_layer

    def counted(*a, **kw):
        calls.append(1)
        return cycle(*a, **kw)

    def counted_layer(pl, *a, **kw):
        if kw.get("causal") is False:  # only the encoder's layers are non-causal self-attention
            enc_calls.append(1)
        return layer(pl, *a, **kw)

    monkeypatch.setattr(T, "_apply_cycle", counted)
    monkeypatch.setattr(T, "_apply_dense_layer", counted_layer)
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        _, _, state, oc = _states(setup, "adamw", cfg=c)
        calls.clear()
        enc_calls.clear()
        state, met = S.make_train_step(c, oc)(state, _tb(batch))
        assert len(calls) == T._num_cycles(c) * (2 if remat else 1)
        assert len(enc_calls) == c.encoder_layers * (c.family == "encdec")
        out[remat] = (float(met["loss"]), float(met["grad_norm"]), state)
    (l_on, g_on, s_on), (l_off, g_off, s_off) = out[True], out[False]
    assert l_on == pytest.approx(l_off, rel=LOSS_RTOL)
    assert g_on == pytest.approx(g_off, rel=LOSS_RTOL)
    for n in s_on.opt.m:
        _close_scaled(s_on.opt.m[n], s_off.opt.m[n].numpy(), GRAD_TOL, n)


def test_launcher_trains_the_cross_layers_and_the_encoder_not_at_all(setup):
    """ROADMAP Queue 3: the launcher's batches (``SyntheticLM``) hold tokens
    and labels only, as the reference's do, so three steps leave the cross
    layers', ``img_proj``'s and Whisper's encoder's moments and weights
    untouched but for weight decay (their gradients are exactly zero), and
    move every other moment."""
    arch, _, cfg, _ = setup
    flags = ["--arch", arch, "--preset", "smoke", "--device", "cpu", "--seq-len", "24",
             "--batch", "2", "--log-every", "1", "--steps", "3"]
    run = train_mod.train(train_mod.parse_args(flags))
    assert len(run.losses) == 3 and all(np.isfinite(run.losses + run.grad_norms))
    opt = run.state.opt
    assert opt.step == 3 and opt.m is not None
    unreached = [n for n in opt.m if _unreached(n)]
    assert unreached and len(unreached) < len(opt.m)
    for n in opt.m:
        if _unreached(n):
            assert not opt.m[n].any() and not opt.v[n].any(), n
        else:
            assert float(opt.m[n].abs().max()) > 0 and float(opt.v[n].abs().max()) > 0, n
