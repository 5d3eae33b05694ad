"""The port's MoE serving path on the CPU against the JAX package.

- ``dispatch_permutation``: ``sort`` and ``counting`` give the reference's
  ``(order, key_sorted, starts, rank)`` bit for bit (int32), overflow keys
  included, and equal each other.
- ``_moe_expert_shard``, ``moe_apply`` and ``_moe_dense_oracle`` on the
  reference's ``init_moe`` weights, at ``capacity_factor`` 8.0 (no drops)
  and 1.0 (drops), with either dispatch method: float32 outputs within
  atol 1e-5 (sums of d_ff = 128 float32 products and k weighted rows, in
  another order than XLA's).
- A 2-layer MoE model (``qwen3-moe-235b-a22b`` reduced, float32) on the
  reference's weights: prefill and decode logits within 1e-4 of max
  |logit|, and the serving engine's greedy tokens equal the reference
  engine's.

The router's logits are float32 sums of random inputs, so no two are
equal: ``torch.topk`` and ``jax.lax.top_k`` order ties differently, and
with no ties both pick the same experts in the same order. On the CPU the
kernels' wrappers run their plain versions (histogram, positions, row
scatter, rows reduce), the routing the card runs with the kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.executor import dispatch_permutation as ref_dispatch
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.params import unbox
from repro.serving.server import Engine as RefEngine
from repro.serving.server import Request as RefRequest
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.executor import dispatch_permutation
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.server import Engine, Request
from repro_torch.train.steps import make_decode_step, make_prefill_step

ARCH = "qwen3-moe-235b-a22b"
LAYER_ATOL = 1e-5


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _configs(**overrides):
    return ref_get_config(ARCH).reduced(**overrides), get_config(ARCH).reduced(**overrides)


# ---------------------------------------------------------------------------
# dispatch routing
# ---------------------------------------------------------------------------


def _keys(case):
    rng = np.random.default_rng(5)
    if case == "uniform":  # every slot, the overflow bin included
        return rng.integers(0, 9, 1000).astype(np.int32), 8
    if case == "skewed":  # half the stream in one slot, a tenth overflowing
        k = rng.integers(0, 128, 4096)
        k[rng.random(4096) < 0.5] = 3
        k[rng.random(4096) < 0.1] = 128
        return k.astype(np.int32), 128
    if case == "one_key":
        return np.full(300, 2, np.int32), 4
    if case == "all_overflow":
        return np.full(64, 16, np.int32), 16
    if case == "decode":  # 4 slots x top-8 of 128
        return rng.permutation(128)[:32].astype(np.int32), 128
    raise ValueError(case)


DISPATCH_CASES = ["uniform", "skewed", "one_key", "all_overflow", "decode"]


@pytest.mark.parametrize("case", DISPATCH_CASES)
@pytest.mark.parametrize("method", ["sort", "counting"])
def test_dispatch_permutation_equals_the_reference_bit_for_bit(method, case):
    keys, slots = _keys(case)
    want = ref_dispatch(jnp.asarray(keys), slots, method=method)
    got = dispatch_permutation(torch.from_numpy(keys), slots, method=method)
    for name, g, w in zip(("order", "key_sorted", "starts", "rank"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_dispatch_sort_and_counting_agree(case):
    keys, slots = _keys(case)
    a = dispatch_permutation(torch.from_numpy(keys), slots, method="sort")
    b = dispatch_permutation(torch.from_numpy(keys), slots, method="counting")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_dispatch_rejects_unknown_methods():
    with pytest.raises(ValueError, match="unknown dispatch method"):
        dispatch_permutation(torch.zeros(4, dtype=torch.int32), 2, method="pallas")


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def _layer(ref_cfg, cfg, seed=3):
    ref_p, _ = unbox(RL.init_moe(jax.random.PRNGKey(seed), ref_cfg))
    p = L.MoE(cfg, "cpu")
    with torch.no_grad():
        for k, v in ref_p.items():
            getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    return ref_p, p


LAYER_CASES = [  # (overrides, tokens): reduced E = 8, top-2; and top-8 of 16
    (dict(), 64),
    (dict(num_experts=16, top_k=8), 48),
]


def _drops(x, p, cfg):
    """Assignments beyond their expert's capacity, counted in numpy."""
    _, ids = L.moe_route(torch.from_numpy(x), p.wr.detach(), cfg)
    counts = np.bincount(ids.reshape(-1).numpy(), minlength=cfg.num_experts)
    return int(np.maximum(counts - L.moe_capacity(x.shape[0], cfg), 0).sum())


@pytest.mark.parametrize("method", ["sort", "counting"])
@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("overrides,T", LAYER_CASES, ids=["e8k2", "e16k8"])
def test_expert_shard_matches_the_reference(overrides, T, cf, method):
    ref_cfg, cfg = _configs(capacity_factor=cf, moe_dispatch_method=method, **overrides)
    ref_p, p = _layer(ref_cfg, cfg)
    x = np.random.default_rng(7).normal(size=(T, cfg.d_model)).astype(np.float32)
    E = cfg.num_experts
    want = jax.jit(lambda p, x: RL._moe_expert_shard(
        x, p["wr"], p["w1"], p["w3"], p["w2"], ref_cfg, 0, E))(ref_p, jnp.asarray(x))
    with torch.no_grad():
        got = L._moe_expert_shard(torch.from_numpy(x), p.wr, p.w1, p.w3, p.w2, cfg, 0, E)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=LAYER_ATOL, rtol=0)
    drops = _drops(x, p, cfg)
    assert (drops > 0) == (cf == 1.0), drops  # the 1.0 case exercises capacity clipping


def test_expert_shard_routes_a_slice_of_the_experts():
    """``e_start`` > 0 with fewer local experts (the shard the sharded path
    will run): the other experts' assignments go to the overflow bin."""
    ref_cfg, cfg = _configs(capacity_factor=2.0)
    ref_p, p = _layer(ref_cfg, cfg)
    x = np.random.default_rng(8).normal(size=(40, cfg.d_model)).astype(np.float32)
    sl = slice(2, 6)
    want = RL._moe_expert_shard(jnp.asarray(x), ref_p["wr"], ref_p["w1"][sl], ref_p["w3"][sl],
                                ref_p["w2"][sl], ref_cfg, 2, 4)
    with torch.no_grad():
        got = L._moe_expert_shard(torch.from_numpy(x), p.wr, p.w1[sl], p.w3[sl], p.w2[sl],
                                  cfg, 2, 4)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("dispatch", ["pb", "dense"])
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_apply_matches_the_reference(cf, dispatch):
    ref_cfg, cfg = _configs(capacity_factor=cf, moe_dispatch=dispatch)
    ref_p, p = _layer(ref_cfg, cfg, seed=4)
    x = np.random.default_rng(9).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: RL.moe_apply(p, x, ref_cfg))(ref_p, jnp.asarray(x))
    with torch.no_grad():
        got = L.moe_apply(p, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("overrides,T", LAYER_CASES, ids=["e8k2", "e16k8"])
def test_dense_oracle_matches_the_reference_and_the_dispatch_without_drops(overrides, T):
    ref_cfg, cfg = _configs(**overrides)  # reduced: capacity_factor 8.0, no drops
    ref_p, p = _layer(ref_cfg, cfg, seed=5)
    x = np.random.default_rng(10).normal(size=(T, cfg.d_model)).astype(np.float32)
    want = RL._moe_dense_oracle(jnp.asarray(x), ref_p["wr"], ref_p["w1"], ref_p["w3"],
                                ref_p["w2"], ref_cfg)
    with torch.no_grad():
        dense = L._moe_dense_oracle(torch.from_numpy(x), p.wr, p.w1, p.w3, p.w2, cfg)
        pb = L._moe_expert_shard(torch.from_numpy(x), p.wr, p.w1, p.w3, p.w2, cfg, 0,
                                 cfg.num_experts)
    np.testing.assert_allclose(dense.numpy(), _np(want), atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(pb.numpy(), dense.numpy(), atol=LAYER_ATOL, rtol=0)


def test_topk_ties_are_counted():
    """A token whose k-th and (k+1)-th logits are equal is a tie; distinct
    logits give none."""
    _, cfg = _configs()
    wr = torch.zeros(cfg.d_model, cfg.num_experts)
    x = torch.randn(5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    assert L.moe_topk_ties(x, wr, cfg) == 5  # all logits 0
    wr[0] = torch.arange(cfg.num_experts, dtype=torch.float32)
    assert L.moe_topk_ties(x.abs() + 1, wr, cfg) == 0


def test_moe_training_and_meshes_raise():
    _, cfg = _configs()
    p = L.MoE(cfg, "cpu")
    torch.nn.init.normal_(p.wr)
    x = torch.zeros(1, 3, cfg.d_model)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        L.moe_apply(p, x, cfg)  # parameters require grad, autograd on


# ---------------------------------------------------------------------------
# the model and its serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    ref_cfg, cfg = _configs()
    params = jax.jit(lambda key: unbox(RT.init_params(key, ref_cfg))[0])(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, cfg, params, model


def _close_logits(got, want):
    want = _np(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-4 * float(np.abs(want).max()),
                               rtol=0)


def test_the_model_carries_the_reference_moe_leaves(lm):
    _, cfg, params, model = lm
    assert cfg.num_layers == 2 and not hasattr(model.blocks[0], "mlp")
    for i in range(cfg.num_layers):
        for k in ("wr", "w1", "w3", "w2"):
            np.testing.assert_array_equal(
                getattr(model.blocks[i].moe, k).detach().numpy(),
                np.asarray(params["blocks"]["moe"][k][i]))


def test_prefill_and_decode_logits_match(lm):
    ref_cfg, cfg, params, model = lm
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    ref_logits, ref_st = jax.jit(ref_prefill_step(ref_cfg, 32))(params, {"tokens": jnp.asarray(prompt)})
    logits, st = make_prefill_step(cfg, 32)(model, {"tokens": torch.from_numpy(prompt)})
    _close_logits(logits, ref_logits)
    ref_dec, tok = jax.jit(ref_decode_step(ref_cfg)), jnp.argmax(ref_logits, -1)[:, None]
    dec = make_decode_step(cfg)
    ttok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    for _ in range(3):
        rl, rnext, ref_st = ref_dec(params, ref_st, tok.astype(jnp.int32))
        tl, tnext, st = dec(model, st, ttok)
        _close_logits(tl, rl)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(rnext))
        tok, ttok = rnext[:, None], tnext[:, None]


def test_engine_tokens_equal_the_reference_engine(lm):
    """Five requests over two slots with refills: greedy tokens equal."""
    ref_cfg, cfg, params, model = lm
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 5, 9, 12, 5)]
    ref = RefEngine(ref_cfg, params, slots=2, max_len=48)
    eng = Engine(cfg, model, slots=2, max_len=48)
    for rid, p in enumerate(prompts):
        ref.submit(RefRequest(rid=rid, prompt=p, max_new=5))
        eng.submit(Request(rid=rid, prompt=p, max_new=5))
    want = {r.rid: r.out for r in ref.run_until_drained()}
    got = {r.rid: r.out for r in eng.run_until_drained()}
    assert got == want
    assert eng.state.index == int(ref.state.index)
