"""The port's train step on the CPU against the JAX package's, from one
state: the reference's weights (``lm_params_from_numpy``) and optimizer
state (``train_state_from_numpy``), and numpy batches.

The model is ``qwen2-1.5b``'s reduced config (2 layers, d 64, float32,
``attn_q_block`` 32) with S = 64, so that the reference takes its
blockwise attention, and a loss chunk of 24 (three chunks, the last one
padded). Tolerances from float32 rounding: the loss to rtol 1e-5, each
gradient within 1e-5 of its tensor's max |g|, moments within 1e-5 of
their max. AdamW's first steps move a parameter by about lr in the sign
of its gradient, and an element whose gradient is zero up to rounding
may take either sign on either side, so parameters after k steps are
held within 2 sum(lr_t) + 1e-6; the moments then pin the steps.

One gradient is zero but for rounding: attention's key bias ``bk``
shifts every score of a query by the same amount, which the softmax
ignores (neither package turns keys by RoPE). Its value is rounding of a
sum of the key gradients dL/dk over the tokens, whose scale is that of
the key projection's gradient dL/dwk = x^T dL/dk (x normalised): so
``bk``'s gradient and moments are held to 1e-5 of ``wk``'s largest, and
its gradient must itself be under that.
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
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import steps as S
from repro_torch.train.optimizer import reference_leaf

B, SEQ = 4, 64
CFG_KW = dict(loss_chunk=24)
OC_KW = dict(warmup_steps=2, total_steps=20)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
MOMENT_TOL = 1e-5


def _ref_leaf(tree, name):
    key, layer = reference_leaf(name)
    node = tree
    for k in key.split("."):
        node = node[k]
    node = np.asarray(node, dtype=np.float32)
    return node if layer is None else node[layer]


def _scale_name(name):
    """The tensor whose magnitude scales ``name``'s rounding (docstring)."""
    return name[:-2] + "wk" if name.endswith("attn.bk") else name


def _close_scaled(got, want, tol, what="", scale_of=None):
    want = np.asarray(want, dtype=np.float32)
    ref = want if scale_of is None else np.concatenate(
        [np.asarray(x, np.float32).ravel() for x in scale_of])
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _batch(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, size=(B, SEQ)).astype(np.int32)
    labels = rng.integers(0, 512, size=(B, SEQ)).astype(np.int32)
    labels[1, :7] = -1
    return {"tokens": tokens, "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    rcfg = ref_get_config("qwen2-1.5b").reduced(**CFG_KW)
    cfg = get_config("qwen2-1.5b").reduced(**CFG_KW)
    rparams, _ = unbox(RT.init_params(jax.random.PRNGKey(0), rcfg))
    return rcfg, cfg, rparams


def _states(setup, kind, cfg=None):
    rcfg, cfg0, rparams = setup
    cfg = cfg or cfg0
    roc = RO.OptConfig(kind=kind, **OC_KW)
    oc = O.OptConfig(kind=kind, **OC_KW)
    rstate = RS.TrainState(rparams, RO.init_opt_state(rparams, roc))
    np_params = jax.tree.map(np.asarray, rparams)
    np_opt = jax.tree.map(np.asarray, rstate.opt)
    state = train_state_from_numpy(np_params, np_opt, cfg, device="cpu")
    return rstate, roc, state, oc


def _ref_loss_fn(rcfg):
    def loss_fn(params, batch):
        hidden, _ = RT.hidden_forward(params, batch["tokens"], rcfg)
        return RT.chunked_lm_loss(params, hidden, batch["labels"], rcfg, chunk=rcfg.loss_chunk)
    return loss_fn


def _check_params(state, rstate, lr_sum, what):
    for n, p in state.params.named_parameters():
        want = _ref_leaf(rstate.params, n)
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=2 * lr_sum + 1e-6,
                                   err_msg=f"{what}: {n}")


def _check_moments(state, rstate, what):
    opt, ropt = state.opt, rstate.opt
    assert opt.step == int(ropt.step)
    if opt.m is not None:
        for n in opt.m:
            s = _scale_name(n)
            _close_scaled(opt.m[n], _ref_leaf(ropt.m, n), MOMENT_TOL, f"{what}: m {n}",
                          [_ref_leaf(ropt.m, s)])
            _close_scaled(opt.v[n], _ref_leaf(ropt.v, n), MOMENT_TOL, f"{what}: v {n}",
                          [_ref_leaf(ropt.v, s)])
        return

    def node_at(key):
        node = ropt.v
        for k in key.split("."):
            node = node[k]
        return node if isinstance(node, tuple) else (node,)

    for key, v in opt.v.items():
        for a, b in zip(v if isinstance(v, tuple) else (v,), node_at(key)):
            _close_scaled(a, b, MOMENT_TOL, f"{what}: v {key}", node_at(_scale_name(key)))


def test_loss_and_every_gradient_equal_the_reference(setup):
    rcfg, cfg, rparams = setup
    batch = _batch(0)
    rloss, rgrads = jax.value_and_grad(_ref_loss_fn(rcfg))(
        rparams, jax.tree.map(jnp.asarray, batch))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    loss = S.make_loss_fn(cfg)(model, _tb(batch))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=LOSS_RTOL)
    for n, g in zip(names, grads):
        scale = [_ref_leaf(rgrads, _scale_name(n))]
        _close_scaled(g, _ref_leaf(rgrads, n), GRAD_TOL, n, scale)
        if n.endswith("attn.bk"):
            assert float(g.abs().max()) <= GRAD_TOL * float(np.abs(scale[0]).max())


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_three_steps_equal_the_reference(setup, kind):
    rcfg, cfg, _ = setup
    rstate, roc, state, oc = _states(setup, kind)
    rstep = jax.jit(RS.make_train_step(rcfg, roc))
    step = S.make_train_step(cfg, oc)
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(10 + i)
        rstate, rmet = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, _tb(batch))
        lr_sum += met["lr"]
        assert met["lr"] == pytest.approx(float(rmet["lr"]), rel=1e-6)
        # the parameters that can differ by more than rounding (bk's signs of
        # noise) do not move the loss: every step's loss and gradient agree
        assert float(met["loss"]) == pytest.approx(float(rmet["loss"]), rel=LOSS_RTOL)
        assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]),
                                                        rel=LOSS_RTOL)
        _check_params(state, rstate, lr_sum, f"{kind} step {i + 1}")
        _check_moments(state, rstate, f"{kind} step {i + 1}")
    assert np.isfinite(float(met["loss"]))


def test_accumulation_equals_the_reference_and_the_full_batch(setup):
    rcfg, cfg, _ = setup
    batch = _batch(20)  # row 1 holds 7 masked labels: the microbatches' counts differ
    rstate, roc, s2, oc = _states(setup, "adamw")
    rstate, rmet = jax.jit(RS.make_train_step(rcfg, roc, accum_steps=2))(
        rstate, jax.tree.map(jnp.asarray, batch))
    s2, m2 = S.make_train_step(cfg, oc, accum_steps=2)(s2, _tb(batch))
    assert float(m2["loss"]) == pytest.approx(float(rmet["loss"]), rel=LOSS_RTOL)
    assert float(m2["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=LOSS_RTOL)
    _check_moments(s2, rstate, "accum 2")
    _check_params(s2, rstate, m2["lr"], "accum 2")
    # the accumulated loss is the mean of the two microbatches' means
    _, _, s0, _ = _states(setup, "adamw")
    parts = [float(S.make_loss_fn(cfg)(s0.params, _tb({k: v[i * 2:(i + 1) * 2]
                                                       for k, v in batch.items()})).detach())
             for i in range(2)]
    assert float(m2["loss"]) == pytest.approx(sum(parts) / 2, rel=LOSS_RTOL)

    # with every label valid the mean of means is the full batch's mean, and
    # the summed gradients the full batch's: the step equals accum 1's
    full = dict(batch, labels=np.abs(batch["labels"]))
    out = {}
    for accum in (1, 2):
        _, _, st, _ = _states(setup, "adamw")
        out[accum] = S.make_train_step(cfg, oc, accum_steps=accum)(st, _tb(full))
    (s1, m1), (s2, m2) = out[1], out[2]
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=LOSS_RTOL)
    for n in s1.opt.m:
        _close_scaled(s2.opt.m[n], s1.opt.m[n].numpy(), MOMENT_TOL, n,
                      [s1.opt.m[_scale_name(n)].numpy()])
    for (n, a), (_, b) in zip(s1.params.named_parameters(), s2.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0,
                                   atol=2 * m1["lr"] + 1e-6, err_msg=n)
    with pytest.raises(ValueError, match="microbatches"):
        S.make_train_step(cfg, oc, accum_steps=3)(s1, _tb(batch))


def test_remat_on_equals_remat_off(setup, monkeypatch):
    rcfg, cfg, _ = setup
    batch = _batch(30)
    out, calls = {}, []
    layer = T._apply_dense_layer

    def counted(*a, **kw):
        calls.append(1)
        return layer(*a, **kw)

    monkeypatch.setattr(T, "_apply_dense_layer", counted)
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        _, _, state, oc = _states(setup, "adamw", cfg=c)
        calls.clear()
        state, met = S.make_train_step(c, oc)(state, _tb(batch))
        # with remat each layer runs again in the backward
        assert len(calls) == c.num_layers * (2 if remat else 1)
        out[remat], lr = (float(met["loss"]), state), met["lr"]
    assert out[True][0] == pytest.approx(out[False][0], rel=LOSS_RTOL)
    for (n, a), (_, b) in zip(out[True][1].params.named_parameters(),
                              out[False][1].params.named_parameters()):
        # the same float32 operations recomputed: the same update
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0,
                                   atol=2 * lr + 1e-6, err_msg=n)
    m_on, m_off = out[True][1].opt.m, out[False][1].opt.m
    for n in m_on:
        _close_scaled(m_on[n], m_off[n].numpy(), MOMENT_TOL, n, [m_off[_scale_name(n)].numpy()])


def test_make_batch_and_init_fn():
    cfg = get_config("qwen2-1.5b").reduced()
    from repro_torch.configs.registry import ShapeSpec

    gen = torch.Generator().manual_seed(0)
    b = S.make_batch(cfg, ShapeSpec("t", 16, 3, "train"), gen)
    assert set(b) == {"tokens", "labels"} and b["tokens"].shape == (3, 16)
    assert b["tokens"].dtype == torch.int32 and int(b["tokens"].max()) < cfg.vocab_size
    d = S.make_batch(cfg, ShapeSpec("d", 16, 3, "decode"), gen)
    assert set(d) == {"tokens"} and d["tokens"].shape == (3, 1)
    state = S.make_init_fn(cfg)(seed=0, device="cpu")
    assert state.opt.step == 0 and S.default_opt_config(cfg).kind == "adamw"
    assert set(state.opt.m) == {n for n, _ in state.params.named_parameters()}
    state, met = S.make_train_step(cfg)(state, b)
    assert state.opt.step == 1 and np.isfinite(float(met["loss"]))
    assert any(float(m.abs().max()) > 0 for m in state.opt.m.values())
