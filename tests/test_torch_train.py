"""The training slice's pieces on the CPU against the JAX package: the
learning-rate schedule and both optimizers, the PB embedding backward
(``_pb_take``), flash attention's backward, and the losses.

Inputs are drawn with numpy from a seed and go through both packages.
Tolerances come from float32 rounding, not from the runs: a value summed
in another order differs by a few float32 ulps of the largest term, so
gradients are held within 1e-5 of each tensor's max |g|, moments within
1e-5 of their max, losses to rtol 1e-5, and a learning rate (float32 on
both sides) to rtol 1e-6. A bfloat16 embedding gradient is one float32
sum rounded once to bfloat16 on each side: within one bfloat16 step,
2^-8 |want|, plus the float32 sum's order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.params import unbox
from repro.train import optimizer as RO
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flashattn import flash_attention, flash_attention_ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train.optimizer import reference_leaf

GRAD_TOL = 1e-5  # times the tensor's max |g|
MOMENT_TOL = 1e-5  # times the moment's max


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_scaled(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def _ref_leaf(tree, name):
    key, layer = reference_leaf(name)
    node = tree
    for k in key.split("."):
        node = node[k]
    node = np.asarray(node)
    return node if layer is None else node[layer]


# ---------------------------------------------------------------------------
# schedule and optimizers
# ---------------------------------------------------------------------------


def test_lr_schedule_equals_the_reference():
    oc = O.OptConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    roc = RO.OptConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    steps = np.array([0, 1, 5, 9, 10, 11, 50, 99, 100, 150], np.int32)
    got = O.lr_schedule(oc, steps)
    want = np.asarray(RO.lr_schedule(roc, jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for s in (0, 9, 10, 100):
        assert float(O.lr_schedule(oc, s)) == pytest.approx(float(want[list(steps).index(s)]),
                                                             rel=1e-6)


def _stacked_tree(rng):
    """A reference-shaped tree: a stacked 'blocks' group (2 layers of a
    matrix, a vector and a (1, 4) row), and top-level leaves of rank 1
    and 2."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "blocks": {"w": f(2, 6, 5), "b": f(2, 5), "row": f(2, 1, 4)},
        "embed": {"table": f(9, 6)},
        "final_ln": {"w": f(6)},
    }


def _named(tree):
    """The port's name -> tensor of a reference-shaped tree."""
    out = {}
    for k in ("w", "b", "row"):
        for i in range(2):
            out[f"blocks.{i}.{k}"] = _t(tree["blocks"][k][i])
    out["embed.table"] = _t(tree["embed"]["table"])
    out["final_ln.w"] = _t(tree["final_ln"]["w"])
    return out


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_updates_equals_the_reference(kind):
    rng = np.random.default_rng(3)
    p_np = _stacked_tree(rng)
    kw = dict(kind=kind, lr_peak=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    oc, roc = O.OptConfig(**kw), RO.OptConfig(**kw)
    params = _named(p_np)
    state = O.init_opt_state(params, oc)
    rparams = jax.tree.map(jnp.asarray, p_np)
    rstate = RO.init_opt_state(rparams, roc)
    for _ in range(3):
        g_np = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), p_np)
        params, state, met = O.apply_updates(params, _named(g_np), state, oc)
        rparams, rstate, rmet = RO.apply_updates(rparams, jax.tree.map(jnp.asarray, g_np),
                                                 rstate, roc)
        assert met["lr"] == pytest.approx(float(rmet["lr"]), rel=1e-6)
        assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=1e-5)
        assert state.step == int(rstate.step)
        for n, p in params.items():
            # one float32 update from equal inputs: a few ulps of |p|
            _close_scaled(p, _ref_leaf(rparams, n), 1e-6, n)
        if kind == "adamw":
            for n in params:
                _close_scaled(state.m[n], _ref_leaf(rstate.m, n), MOMENT_TOL, n)
                _close_scaled(state.v[n], _ref_leaf(rstate.v, n), MOMENT_TOL, n)
        else:
            assert state.m is None
            for key, v in state.v.items():
                node = rstate.v
                for k in key.split("."):
                    node = node[k]
                if isinstance(node, tuple):  # factored: rows and columns
                    assert isinstance(v, tuple)
                    _close_scaled(v[0], node[0], MOMENT_TOL, key)
                    _close_scaled(v[1], node[1], MOMENT_TOL, key)
                else:
                    assert not isinstance(v, tuple)
                    _close_scaled(v, node, MOMENT_TOL, key)
    if kind == "adafactor":  # the stacked leaves factor across the layers
        assert isinstance(state.v["blocks.b"], tuple) and state.v["blocks.b"][0].shape == (2,)
        assert not isinstance(state.v["blocks.row"], tuple)  # (2, 1, 4): a 1-row matrix
        assert not isinstance(state.v["final_ln.w"], tuple)


# ---------------------------------------------------------------------------
# the PB embedding backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pb_take_forward_and_backward_equal_the_reference(dtype):
    rng = np.random.default_rng(5)
    V, d = 37, 8
    table = rng.normal(size=(V, d)).astype(np.float32)
    ids = rng.integers(0, V, size=(3, 11)).astype(np.int32)
    ids[0, :4] = 7  # repeated ids
    ids[1, -1] = V - 1
    ids[2, 3] = V - 1
    g = rng.normal(size=(3, 11, d)).astype(np.float32)

    jdt = jnp.dtype(dtype)
    rtab = jnp.asarray(table).astype(jdt)
    rout, vjp = jax.vjp(lambda t: RL._pb_take(t, jnp.asarray(ids)), rtab)
    (rgrad,) = vjp(jnp.asarray(g).astype(jdt))

    tdt = getattr(torch, dtype)
    tab = _t(table).to(tdt).requires_grad_()
    out = L._pb_take(tab, _t(ids))
    (grad,) = torch.autograd.grad(out, tab, _t(g).to(tdt))
    assert out.dtype == tdt and grad.dtype == tdt
    assert torch.equal(out.float(), _t(rout.astype(jnp.float32)))
    want = np.asarray(rgrad.astype(jnp.float32))
    # float32: sums of at most 4 rows in another order
    scale = np.zeros((V, d), np.float32)
    np.add.at(scale, ids.reshape(-1), np.abs(np.asarray(jnp.asarray(g).astype(jdt)
                                                         .astype(jnp.float32))).reshape(-1, d))
    tol = 1e-6 * scale + (2.0**-8 * np.abs(want) if dtype == "bfloat16" else 0)
    assert (np.abs(grad.float().numpy() - want) <= tol + 1e-7).all()
    untouched = np.setdiff1d(np.arange(V), ids)
    assert (grad.float().numpy()[untouched] == 0).all()


def test_embed_apply_switches_on_pb_embedding():
    cfg = get_config("qwen2-1.5b").reduced()
    model = T.init_params(cfg, seed=1, device="cpu")
    ids = torch.tensor([[1, 2, 2, 5]], dtype=torch.int32)
    grads = {}
    for pb in (True, False):
        c = dataclasses.replace(cfg, pb_embedding=pb)
        out = L.embed_apply(model.embed, ids, c)
        (grads[pb],) = torch.autograd.grad(out.sum(), model.embed.table)
    assert torch.allclose(grads[True], grads[False], atol=1e-6)
    assert grads[True][2].sum() == pytest.approx(2 * cfg.d_model)


# ---------------------------------------------------------------------------
# flash attention's backward
# ---------------------------------------------------------------------------


def _direct_grads(q, k, v, w, causal):
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    out = L._direct_attention(qq, kk, vv, causal=causal)
    return torch.autograd.grad((out * w).sum(), (qq, kk, vv))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KH,hd,qb", [(2, 50, 6, 2, 16, 16), (1, 64, 4, 4, 8, 64),
                                            (1, 33, 4, 1, 16, 7)])
def test_flash_backward_equals_autograd_and_the_reference(causal, B, S, H, KH, hd, qb):
    rng = np.random.default_rng(B * S + H)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, hd)).astype(np.float32)
    w = rng.normal(size=(B, S, H * hd)).astype(np.float32)

    qq, kk, vv = (_t(x).requires_grad_() for x in (q, k, v))
    out = L.blockwise_attention(qq, kk, vv, causal=causal, q_block=qb)
    got = torch.autograd.grad((out * _t(w)).sum(), (qq, kk, vv))
    assert out.grad_fn is not None

    want_direct = _direct_grads(_t(q), _t(k), _t(v), _t(w), causal)

    def ref_loss(q, k, v):
        o = RL.blockwise_attention(q, k, v, causal=causal, q_block=qb, kv_block=qb)
        return (o * w).sum()

    want_ref = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    for name, a, b, c in zip("qkv", got, want_direct, want_ref):
        _close_scaled(a, b.numpy(), GRAD_TOL, f"d{name} vs autograd")
        _close_scaled(a, c, GRAD_TOL, f"d{name} vs jax.grad")


def test_flash_backward_bf16_takes_the_plain_gradient_in_float32():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, s, 37, 16, generator=g) for s in (6, 2, 2))
    go = torch.randn(1, 6, 37, 16, generator=g)
    args = [x.to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*args, causal=True, q_block=8)
    got = torch.autograd.grad(out, args, go.to(torch.bfloat16))
    f32 = [x.detach().float().requires_grad_() for x in args]
    want = torch.autograd.grad(flash_attention_ref(*f32, causal=True), f32,
                               go.to(torch.bfloat16).float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        # one float32 gradient rounded once to bfloat16, summed in another order
        assert ((a.float() - b).abs() <= 2.0**-8 * b.abs() + 1e-5 * b.abs().max()).all()


def test_flash_forward_has_no_graph_under_inference_mode():
    q = torch.randn(1, 2, 5, 16)
    k = torch.randn(1, 1, 5, 16)
    with torch.inference_mode():
        out = flash_attention(q, k, k)
    assert out.grad_fn is None and torch.equal(out, flash_attention_ref(q, k, k))
    with pytest.raises(ValueError, match="q_block"):
        flash_attention(q, k, k, q_block=0)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_setup(seed, vocab=500, S=45):
    cfg_kw = dict(vocab_size=vocab)  # padded to 512: 12 padded logits
    rcfg = ref_get_config("qwen2-1.5b").reduced(**cfg_kw)
    cfg = get_config("qwen2-1.5b").reduced(**cfg_kw)
    assert cfg.padded_vocab > cfg.vocab_size
    rparams, _ = unbox(RT.init_params(jax.random.PRNGKey(seed), rcfg))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(3, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, vocab, size=(3, S)).astype(np.int32)
    labels[0, :5] = -1
    labels[2, -3:] = -1
    return rcfg, cfg, rparams, model, hidden, labels


@pytest.mark.parametrize("chunk", [16, 45, 512])
def test_chunked_lm_loss_value_and_grads_equal_the_reference(chunk):
    rcfg, cfg, rparams, model, hidden, labels = _loss_setup(chunk)

    def ref(params, h):
        return RT.chunked_lm_loss(params, h, jnp.asarray(labels), rcfg, chunk=chunk)

    rloss, (rg_params, rg_h) = jax.value_and_grad(ref, argnums=(0, 1))(rparams, hidden)
    h = _t(hidden).requires_grad_()
    loss = T.chunked_lm_loss(model, h, _t(labels), cfg, chunk=chunk)
    g_h, g_tab = torch.autograd.grad(loss, (h, model.embed.table))
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=1e-5)
    _close_scaled(g_h, rg_h, GRAD_TOL, "hidden")
    _close_scaled(g_tab, rg_params["embed"]["table"], GRAD_TOL, "table")
    # without autograd: the same value, no checkpointing
    with torch.no_grad():
        assert float(T.chunked_lm_loss(model, h, _t(labels), cfg, chunk=chunk)) == \
            pytest.approx(float(rloss), rel=1e-5)


def test_lm_loss_equals_the_reference():
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(2, 9, 512)) * 4).astype(np.float32)
    labels = rng.integers(0, 500, size=(2, 9)).astype(np.int32)
    labels[1, 2] = -1
    want = float(RT.lm_loss(jnp.asarray(logits), jnp.asarray(labels), 500))
    got = float(T.lm_loss(_t(logits), _t(labels), 500))
    assert got == pytest.approx(want, rel=1e-5)
    rcfg, cfg, rparams, model, hidden, labels = _loss_setup(1, S=12)
    with torch.no_grad():
        full = L.logits_apply(model.embed, _t(hidden), cfg)
        assert float(T.lm_loss(full, _t(labels), cfg.vocab_size)) == pytest.approx(
            float(T.chunked_lm_loss(model, _t(hidden), _t(labels), cfg, chunk=5)), rel=1e-5)
