"""The port's ssm (``xlstm-350m``) and hybrid (``zamba2-2.7b``) families
on the CPU against the JAX package.

Reduced configs, float32, the reference's weights (``PRNGKey(0)``) carried
across by ``lm_params_from_numpy``, numpy tokens from a seed. ``forward``,
prefill + decode chains and their caches, ``init_cache``'s layout, the
converter, the init rule, and the ``Engine`` against the reference engine
with three slots. Logits within atol 1e-4 * max |logit| and caches
within 1e-4 * max(1, max |ref|): float32 sums in another order, carried
through every layer below the one that wrote the cache (a single block
holds 1e-5, ``tests/test_torch_ssm.py``); greedy tokens equal. The reference's ``_splice_slot`` files the hybrid family's Mamba2
states into batch row 0 whatever the slot (ROADMAP Queue 3); the port
keeps that, and a test pins it. Their training is held to the reference
in ``tests/test_torch_train_families.py``; a step of the vlm and encdec
families runs here (``tests/test_torch_train_cross.py`` holds them to the
reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.params import unbox
from repro.serving.server import Engine as RefEngine
from repro.serving.server import Request as RefRequest
from repro.serving.server import _splice_slot as ref_splice_slot
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving.server import Engine, Request, _splice_slot
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step

ARCHS = ["xlstm-350m", "zamba2-2.7b"]
MAX_LEN = 64


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _close_logits(got, want):
    want = _np(want)
    tol = 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, rtol=0)


def _close_state(got, want):
    want = _np(want)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, rtol=0)


def _pairs(port, ref):
    """(port tensor, reference array) for every leaf of the port's cache
    tree, the reference's found by the same keys and positions."""
    if isinstance(port, dict):
        return [pr for k in port for pr in _pairs(port[k], ref[k])]
    if isinstance(port, tuple):
        assert len(port) == len(ref)
        return [pr for p, r in zip(port, ref) for pr in _pairs(p, r)]
    return [(port, ref)]


_BUILT = {}


def _build(arch):
    """(reference config, port config, reference params, port model, the
    reference's jitted prefill and decode steps), built once per arch."""
    if arch not in _BUILT:
        ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
        params = jax.jit(lambda key: unbox(RT.init_params(key, ref_cfg))[0])(jax.random.PRNGKey(0))
        model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
        steps = (jax.jit(ref_prefill_step(ref_cfg, MAX_LEN)), jax.jit(ref_decode_step(ref_cfg)))
        _BUILT[arch] = (ref_cfg, cfg, params, model, steps)
    return _BUILT[arch]


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return _build(request.param)


def test_forward_matches_the_reference(lm):
    """No state: the training-mode backbone and the full logits, S = 37
    (two chunks of 16 and a ragged 5)."""
    ref_cfg, cfg, params, model, _ = lm
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    want_h, _ = RT.hidden_forward(params, jnp.asarray(toks), ref_cfg)
    want_l, _ = RT.forward(params, jnp.asarray(toks), ref_cfg)
    with torch.inference_mode():
        got_h, st = T.hidden_forward(model, torch.from_numpy(toks), cfg)
        got_l, _ = T.forward(model, torch.from_numpy(toks), cfg)
    assert st is None
    np.testing.assert_allclose(got_h.numpy(), _np(want_h), atol=1e-4, rtol=0)
    _close_logits(got_l, want_l)
    assert got_l.shape == (2, 37, cfg.padded_vocab)


@pytest.mark.parametrize("S", [6, 40])
def test_prefill_and_decode_chain_matches(lm, S):
    """Prefill of S tokens, then 4 greedy decode steps: logits, tokens, and
    every cache leaf at the end."""
    ref_cfg, cfg, params, model, (rpre, rdec) = lm
    toks = np.random.default_rng(S + 1).integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    want, rst = rpre(params, {"tokens": jnp.asarray(toks)})
    got, tst = make_prefill_step(cfg, MAX_LEN)(model, {"tokens": torch.from_numpy(toks)})
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
    for t, r in _pairs(tst.caches, rst.caches):
        _close_state(t, r)


def test_init_cache_matches_the_reference_layout(lm):
    ref_cfg, cfg, _, _, _ = lm
    st = T.init_cache(cfg, 3, 20, device="cpu")
    ref = RT.init_cache(ref_cfg, 3, 20)
    pairs = _pairs(st.caches, ref.caches)
    assert len(pairs) == len(jax.tree.leaves(ref.caches)) == len(T.cache_leaves(st.caches))
    for t, r in pairs:
        assert tuple(t.shape) == r.shape and t.dtype == getattr(torch, str(r.dtype))
        assert not t.any()
    assert st.index == int(ref.index) == 0


def test_converter_places_every_leaf_and_refuses_extras(lm):
    """Each parameter holds the reference leaf of its path (the hybrid's
    Mamba2 leaves indexed by cycle and block), and a leaf the model has
    no place for raises."""
    _, cfg, params, model, _ = lm
    tree = jax.tree.map(np.asarray, params)
    if cfg.family == "hybrid":
        want = tree["blocks"]["mamba"]["mamba"]["in_proj"][1, 1]
        np.testing.assert_array_equal(model.blocks[1].mamba[1].mamba.in_proj.detach().numpy(), want)
        np.testing.assert_array_equal(model.shared_attn.attn.wq.detach().numpy(),
                                      tree["shared_attn"]["attn"]["wq"])
    else:
        want = tree["blocks"]["slstm"]["r"][1]
        np.testing.assert_array_equal(model.blocks[1].slstm.r.detach().numpy(), want)
    tree["final_ln"]["extra"] = np.zeros(cfg.d_model, np.float32)
    with pytest.raises(ValueError, match="extra"):
        lm_params_from_numpy(tree, cfg, device="cpu")


def _ref_names(params, cfg):
    """The port's parameter names for the reference tree's leaves: one per
    cycle of a ``blocks`` leaf, one per (cycle, block) of a hybrid Mamba2
    leaf."""
    nc = T._num_cycles(cfg)
    names = set()
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        if keys[0] != "blocks":
            names.add(".".join(keys))
        elif keys[1] == "mamba":
            names.update(f"blocks.{i}.mamba.{j}.{'.'.join(keys[2:])}"
                         for i in range(nc) for j in range(cfg.attn_every))
        else:
            names.update(f"blocks.{i}.{'.'.join(keys[1:])}" for i in range(nc))
    return names


def test_init_params_follows_the_reference_rule_leaf_by_leaf(lm):
    """The reference's paths; A_log = 0, D = 1, dt_bias = 0, norm weights
    (``w``, ``norm_w``) one, biases zero; projections truncated normals
    within two scales (``r`` by hd^-0.5, the rest by fan-in or their
    reference scale); one seed, one model."""
    _, cfg, params, _, _ = lm
    a = T.init_params(cfg, seed=3, device="cpu")
    b = T.init_params(cfg, seed=3, device="cpu")
    assert {n for n, _ in a.named_parameters()} == _ref_names(params, cfg)
    H, hd = cfg.num_heads, cfg.head_dim
    scale = {"wo": (H * hd) ** -0.5, "w2": cfg.d_ff**-0.5 if cfg.d_ff else None,
             "table": 1.0, "r": hd**-0.5}
    seen = set()
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        p = p.detach()
        assert torch.equal(p, q)
        leaf = n.rsplit(".", 1)[-1]
        seen.add(leaf)
        if leaf in ("w", "norm_w", "D"):
            assert bool((p == 1).all()), n
        elif leaf in ("A_log", "dt_bias") or leaf.startswith("b"):
            assert not p.any(), n
        else:
            s = scale.get(leaf) or p.shape[0] ** -0.5
            assert float(p.abs().max()) <= 2 * s * (1 + 1e-6), n
            assert 0.5 * s < float(p.float().std()) < s, n
    family = {"ssm": {"in_proj", "out_proj", "norm_w", "w_in", "r", "b"},
              "hybrid": {"in_proj", "conv_w", "A_log", "D", "dt_bias", "norm_w", "out_proj"}}
    assert family[cfg.family] <= seen


def test_engine_tokens_equal_the_reference_engine(lm):
    """Six requests of four prompt lengths over three slots, with refills:
    every request's tokens equal the reference engine's (in the hybrid
    family, with the reference's splice of the Mamba2 states)."""
    ref_cfg, cfg, params, model, _ = lm
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 5, 20, 12, 5, 3)]
    ref = RefEngine(ref_cfg, params, slots=3, max_len=MAX_LEN)
    eng = Engine(cfg, model, slots=3, max_len=MAX_LEN)
    for rid, p in enumerate(prompts):
        ref.submit(RefRequest(rid=rid, prompt=p, max_new=5))
        eng.submit(Request(rid=rid, prompt=p, max_new=5))
    want = {r.rid: r.out for r in ref.run_until_drained()}
    got = {r.rid: r.out for r in eng.run_until_drained()}
    assert got == want
    assert eng.state.index == int(ref.state.index)


def _prefilled(lm, slots, slot, n_tokens):
    """Reference and port engine states of ``slots`` slots with one prompt
    prefilled and spliced into ``slot``."""
    ref_cfg, cfg, params, model, (rpre, _) = lm
    toks = np.random.default_rng(n_tokens).integers(0, cfg.vocab_size, (1, n_tokens)).astype(np.int32)
    _, r1 = rpre(params, {"tokens": jnp.asarray(toks)})
    _, t1 = make_prefill_step(cfg, MAX_LEN)(model, {"tokens": torch.from_numpy(toks)})
    with torch.inference_mode():
        tst = _splice_slot(T.init_cache(cfg, slots, MAX_LEN, device="cpu"), t1, slot)
    rst = ref_splice_slot(RT.init_cache(ref_cfg, slots, MAX_LEN), r1, slot)
    return tst, rst, t1, r1


def test_splice_slot_equals_the_reference_leaf_by_leaf(lm):
    tst, rst, _, _ = _prefilled(lm, 3, 2, 7)
    for t, r in _pairs(tst.caches, rst.caches):
        _close_state(t, r)
    assert tst.index == int(rst.index) == 7


def test_hybrid_splice_files_mamba_states_in_row_0_as_the_reference_does():
    """ROADMAP Queue 3: the reference's ``_splice_slot`` updates every
    cache leaf at axis 1, which is the block axis of the hybrid's Mamba2
    states (cycles, attn_every, B, ...): JAX clamps the slot to 0 there,
    and a request admitted to slot 2 of 3 has its Mamba2 states written to
    batch row 0 of every block, rows 1 and 2 left zero. Its KV caches go
    to row 2. The port does the same."""
    tst, rst, t1, _ = _prefilled(_build("zamba2-2.7b"), 3, 2, 9)
    for side, caches in (("port", tst.caches), ("reference", rst.caches)):
        ssm, conv = (np.asarray(a) for a in caches["mamba"])
        k, v = (_np(a) for a in caches["kv"])
        for leaf, want in ((ssm, t1.caches["mamba"][0]), (conv, t1.caches["mamba"][1])):
            assert leaf.shape[2] == 3, side
            np.testing.assert_allclose(leaf[:, :, 0], want[:, :, 0].numpy(), atol=1e-5, err_msg=side)
            assert not leaf[:, :, 1:].any(), side  # the slot's own row stays zero
            assert np.abs(leaf[:, :, 0]).max() > 0, side
        np.testing.assert_allclose(k[:, 2], t1.caches["kv"][0][:, 0].numpy(), atol=1e-5)
        assert not k[:, :2].any() and not v[:, :2].any(), side


def test_ssm_splice_files_every_state_in_its_slot():
    """The ssm family's states are stacked once (cycles, B, ...): the slot
    is axis 1, and a prefill spliced into slot 1 lands in row 1 only."""
    tst, _, t1, _ = _prefilled(_build("xlstm-350m"), 3, 1, 11)
    for dst, src in zip(T.cache_leaves(tst.caches), T.cache_leaves(t1.caches)):
        assert torch.equal(dst[:, 1], src[:, 0])
        assert not dst[:, 0].any() and not dst[:, 2].any()


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-base"])
def test_make_train_step_runs_for_the_cross_families(arch):
    """The recurrent families train (``tests/test_torch_train_families.py``),
    and so, since this test had them raise, do the vlm and encdec families
    (``tests/test_torch_train_cross.py``): one step of ``make_batch``'s
    batch, frontend input included, moves every moment."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.train.steps import make_batch, make_init_fn

    cfg = get_config(arch).reduced()
    batch = make_batch(cfg, ShapeSpec("t", 12, 2, "train"), torch.Generator().manual_seed(0))
    state, met = make_train_step(cfg)(make_init_fn(cfg)(0, device="cpu"), batch)
    assert np.isfinite(float(met["loss"])) and state.opt.step == 1
    assert all(float(m.abs().max()) > 0 for m in state.opt.m.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_the_recurrent_families(arch):
    """``launch/serve.py --preset smoke --device cpu``: every request done."""
    argv = ["--arch", arch, "--preset", "smoke", "--device", "cpu", "--requests", "3",
            "--max-new", "4", "--max-len", "64"]
    assert serve.main(argv) == 3
