"""The port's dense LM on the CPU against the JAX package.

Configs and the registry equal the reference's field by field; each layer
(``apply_norm``, ``rope``, ``mlp_apply``, ``attention_apply`` without a
cache below and above ``attn_q_block``, at prefill with a cache, at
decode) and the model (``hidden_forward``, prefill and decode steps) give
the reference's outputs on the reference's weights, carried across by
``lm_params_from_numpy``. Everything is float32: activations within atol
1e-5 (layers) and logits within atol 1e-4 * max|logit|; greedy tokens
must be equal. Attention runs the plain version of the flash kernel here,
the routing the card runs with the kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.config import flops_per_token as ref_flops_per_token
from repro.models.params import unbox
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import flops_per_token
from repro_torch.train.steps import make_decode_step, make_prefill_step

WIDE = dict(d_model=256, num_heads=12, num_kv_heads=2, head_dim=128)  # qwen2's G = 6, hd = 128


def _fields(cfg):
    return dataclasses.asdict(cfg)


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _close_logits(got, want):
    want = _np(want)
    tol = 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------


def test_registry_lists_the_reference_architectures():
    assert list_archs() == ref_list_archs()
    from repro.configs import SHAPES as REF_SHAPES

    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()
    }


@pytest.mark.parametrize("arch", ref_list_archs())
def test_config_fields_equal_the_reference(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert _fields(cfg) == _fields(ref)
    assert _fields(cfg.reduced()) == _fields(ref.reduced())
    assert _fields(cfg.reduced(**WIDE)) == _fields(ref.reduced(**WIDE))
    assert cfg.padded_vocab == ref.padded_vocab
    assert flops_per_token(cfg) == ref_flops_per_token(ref)
    assert cfg.pdtype == getattr(torch, ref.param_dtype)
    assert cfg.cdtype == getattr(torch, ref.compute_dtype)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "xlstm-350m", "zamba2-2.7b",
                                  "whisper-base"])
def test_other_families_return_a_config_and_the_model_raises(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        T.DenseLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        T.init_cache(cfg, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# fixtures: the reference's weights in both packages
# ---------------------------------------------------------------------------


def _build(overrides):
    ref_cfg = ref_get_config("qwen2-1.5b").reduced(**overrides)
    cfg = get_config("qwen2-1.5b").reduced(**overrides)
    params = jax.jit(lambda key: unbox(RT.init_params(key, ref_cfg))[0])(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, cfg, params, model


@pytest.fixture(scope="module", params=[{}, WIDE], ids=["reduced", "wide_heads"])
def lm(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def small():
    return _build({})


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["rms", "ln"])
def test_apply_norm_matches(norm_type):
    cfg = get_config("qwen2-1.5b").reduced(norm_type=norm_type)
    ref_cfg = ref_get_config("qwen2-1.5b").reduced(norm_type=norm_type)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32) * 3
    w = rng.normal(size=cfg.d_model).astype(np.float32)
    b = rng.normal(size=cfg.d_model).astype(np.float32)
    p = L.Norm(cfg, "cpu")
    with torch.no_grad():
        p.w.copy_(torch.from_numpy(w))
        if p.b is not None:
            p.b.copy_(torch.from_numpy(b))
    ref_p = {"w": jnp.asarray(w), **({"b": jnp.asarray(b)} if norm_type == "ln" else {})}
    want = RL.apply_norm(ref_p, jnp.asarray(x), ref_cfg)
    got = L.apply_norm(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply_matches(act):
    cfg = get_config("qwen2-1.5b").reduced(act_type=act)
    ref_cfg = ref_get_config("qwen2-1.5b").reduced(act_type=act)
    ref_p, _ = unbox(RL.init_mlp(jax.random.PRNGKey(3), ref_cfg))
    p = L.MLP(cfg, "cpu")
    with torch.no_grad():
        for k, v in ref_p.items():
            getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    x = np.random.default_rng(3).normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    want = RL.mlp_apply(ref_p, jnp.asarray(x), ref_cfg)
    got = L.mlp_apply(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-5, rtol=0)


def _attn_inputs(cfg, S, seed):
    x = np.random.default_rng(seed).normal(size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    return x, pos


@pytest.mark.parametrize("S", [20, 50])  # below and above attn_q_block = 32
def test_attention_without_cache_matches(lm, S):
    ref_cfg, cfg, params, model = lm
    x, pos = _attn_inputs(cfg, S, S)
    want, _ = jax.jit(lambda p, x, pos: RL.attention_apply(p, x, ref_cfg, positions=pos))(
        _layer0(params)["attn"], jnp.asarray(x), jnp.asarray(pos))
    with torch.inference_mode():
        got, cache = L.attention_apply(
            model.blocks[0].attn, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)


def test_attention_prefill_then_decode_with_cache_matches(lm):
    """Prefill of 10 tokens into a 64-long cache, then one decode token at
    index 10: outputs and every cache row equal the reference's."""
    ref_cfg, cfg, params, model = lm
    S, max_len = 10, 64
    x, pos = _attn_inputs(cfg, S + 1, 7)
    shape = (2, max_len, cfg.num_kv_heads, cfg.head_dim)
    rc = (jnp.zeros(shape), jnp.zeros(shape))
    tc = (torch.zeros(shape), torch.zeros(shape))
    rp, tp = _layer0(params)["attn"], model.blocks[0].attn
    steps = [(slice(0, S), 0), (slice(S, S + 1), S)]
    ref_step = jax.jit(lambda p, x, pos, c, i: RL.attention_apply(
        p, x, ref_cfg, positions=pos, cache=c, cache_index=i))
    with torch.inference_mode():
        for sl, index in steps:
            want, rc = ref_step(rp, jnp.asarray(x[:, sl]), jnp.asarray(pos[:, sl]), rc,
                                jnp.asarray(index, jnp.int32))
            got, tc = L.attention_apply(
                tp, torch.from_numpy(x[:, sl]), cfg, positions=torch.from_numpy(pos[:, sl]),
                cache=tc, cache_index=index)
            np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
            for t, r in zip(tc, rc):
                np.testing.assert_allclose(t.numpy(), _np(r), atol=1e-5, rtol=0)


def test_attention_refuses_a_prefill_away_from_index_zero(small):
    _, cfg, _, model = small
    x, pos = _attn_inputs(cfg, 4, 0)
    shape = (2, 16, cfg.num_kv_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="prefill"), torch.inference_mode():
        L.attention_apply(model.blocks[0].attn, torch.from_numpy(x), cfg,
                          positions=torch.from_numpy(pos),
                          cache=(torch.zeros(shape), torch.zeros(shape)), cache_index=3)


# ---------------------------------------------------------------------------
# the model: backbone, logits, prefill and decode steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [6, 40])
def test_hidden_forward_and_logits_match(lm, S):
    ref_cfg, cfg, params, model = lm
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    want_h, want_l = jax.jit(lambda p, t: (
        RT.hidden_forward(p, t, ref_cfg)[0], RT.forward(p, t, ref_cfg)[0]))(params, jnp.asarray(toks))
    with torch.inference_mode():
        got_h, st = T.hidden_forward(model, torch.from_numpy(toks), cfg)
        got_l, _ = T.forward(model, torch.from_numpy(toks), cfg)
    assert st is None
    np.testing.assert_allclose(got_h.numpy(), _np(want_h), atol=1e-4, rtol=0)
    _close_logits(got_l, want_l)
    assert got_l.shape == (2, S, cfg.padded_vocab) and got_l.dtype == torch.float32


@pytest.fixture(scope="module")
def ref_steps():
    return {}


@pytest.mark.parametrize("S", [6, 40])
def test_prefill_and_decode_steps_match(lm, ref_steps, S):
    """Prefill, then 4 greedy decode steps: logits and tokens."""
    ref_cfg, cfg, params, model = lm
    key = (cfg.d_model, cfg.num_heads)
    if key not in ref_steps:
        ref_steps[key] = (jax.jit(ref_prefill_step(ref_cfg, 64)), jax.jit(ref_decode_step(ref_cfg)))
    rpre, rdec = ref_steps[key]
    toks = np.random.default_rng(S + 1).integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    want, rst = rpre(params, {"tokens": jnp.asarray(toks)})
    got, tst = make_prefill_step(cfg, 64)(model, {"tokens": torch.from_numpy(toks)})
    _close_logits(got, want)
    assert tst.index == int(rst.index) == S
    tdec = make_decode_step(cfg)
    rt = jnp.argmax(want, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(got, -1).to(torch.int32)[:, None]
    assert int(rt[0, 0]) == int(tt[0, 0])
    for _ in range(4):
        wl, rn, rst = rdec(params, rst, rt)
        gl, tn, tst = tdec(model, tst, tt)
        _close_logits(gl, wl)
        assert tn.tolist() == np.asarray(rn).tolist()
        rt, tt = rn[:, None], tn[:, None]
    assert tst.index == int(rst.index) == S + 4
    for t, r in zip(tst.caches, (rst.caches["kv"][0], rst.caches["kv"][1])):
        np.testing.assert_allclose(t.numpy(), _np(r), atol=1e-5, rtol=0)


def test_init_cache_matches_the_reference_layout(small):
    ref_cfg, cfg, _, _ = small
    st = T.init_cache(cfg, 3, 20, device="cpu")
    ref = RT.init_cache(ref_cfg, 3, 20)
    for t, r in zip(st.caches, ref.caches["kv"]):
        assert tuple(t.shape) == r.shape and t.dtype == getattr(torch, str(r.dtype))
        assert not t.any()
    assert st.index == int(ref.index) == 0


# ---------------------------------------------------------------------------
# weights: the converter and the init rule
# ---------------------------------------------------------------------------


def test_converter_carries_bfloat16_bits():
    """bf16 reference arrays (ml_dtypes) arrive bit for bit."""
    ref_cfg = ref_get_config("qwen2-1.5b").reduced(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = get_config("qwen2-1.5b").reduced(param_dtype="bfloat16", compute_dtype="bfloat16")
    params = jax.jit(lambda key: unbox(RT.init_params(key, ref_cfg))[0])(jax.random.PRNGKey(1))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    assert model.blocks[1].attn.wq.dtype == torch.bfloat16
    assert model.final_ln.w.dtype == torch.float32  # norms stay float32, as in the reference
    want = np.asarray(params["blocks"]["mlp"]["w2"])[1].view(np.int16)
    assert np.array_equal(model.blocks[1].mlp.w2.detach().view(torch.int16).numpy(), want)
    np.testing.assert_array_equal(
        model.embed.table.detach().float().numpy(), np.asarray(params["embed"]["table"], np.float32))


def test_converter_refuses_a_tree_it_cannot_place(small):
    _, cfg, params, _ = small
    tree = jax.tree.map(np.asarray, params)
    tree["embed"]["unembed"] = np.zeros((cfg.d_model, cfg.padded_vocab), np.float32)
    with pytest.raises(ValueError, match="unembed"):
        lm_params_from_numpy(tree, cfg, device="cpu")


def test_init_params_follows_the_reference_rule(small):
    """The same parameter paths as the reference's tree; truncated normals
    within 2 scales, norms one, biases zero; one seed, one model."""
    ref_cfg, cfg, params, _ = small
    a = T.init_params(cfg, seed=3, device="cpu")
    b = T.init_params(cfg, seed=3, device="cpu")
    names = {n for n, _ in a.named_parameters()}
    ref_paths = set()
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            ref_paths.update(f"blocks.{i}.{'.'.join(keys[1:])}" for i in range(cfg.num_layers))
        else:
            ref_paths.add(".".join(keys))
    assert names == ref_paths
    scale = {"wo": (cfg.num_heads * cfg.head_dim) ** -0.5, "w2": cfg.d_ff**-0.5, "table": 1.0}
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q)
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "w":
            assert bool((p == 1).all())
        elif leaf.startswith("b"):
            assert not p.any()
        else:
            s = scale.get(leaf, p.shape[0] ** -0.5)
            assert float(p.detach().abs().max()) <= 2 * s * (1 + 1e-6)
            assert 0.5 * s < float(p.detach().std()) < s
