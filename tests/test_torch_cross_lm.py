"""The port's vlm (``llama-3.2-vision-11b``) and encdec (``whisper-base``)
families served on the CPU against the JAX package.

Reduced configs, float32, the reference's weights (``PRNGKey(0)``) carried
across by ``lm_params_from_numpy``, numpy tokens, image and frame
embeddings from a seed. Cross-attention (``attention_apply`` with
``kv_src``) in its three modes, ``hidden_forward`` with and without the
frontend inputs, prefill + decode chains with every cache leaf,
``init_cache``'s layout, the converter, the init rule, ``make_batch``
against ``batch_struct``, the ``Engine`` against the reference engine
with three slots, and the serve launcher. Layers within atol 1e-5,
logits within 1e-4 * max |logit|, caches within 1e-4 * max(1, max
|ref|) (float32 sums in another order below the layer that wrote them);
greedy tokens equal. Two reference faults that this slice keeps are
pinned here (ROADMAP Queue 3): the ``Engine`` passes prompts only, so a
served prefill projects the cross keys and values from the prompt itself
and attends over them and the cross cache's zero rows; and the vlm's
self-attention caches, stacked twice, are spliced into batch row 0.
Their training is held to the reference in
``tests/test_torch_train_cross.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.registry import ShapeSpec as RefShapeSpec
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.params import unbox
from repro.serving.server import Engine as RefEngine
from repro.serving.server import Request as RefRequest
from repro.serving.server import _splice_slot as ref_splice_slot
from repro.train.steps import batch_struct
from repro.train.steps import make_decode_step as ref_decode_step
from repro.train.steps import make_prefill_step as ref_prefill_step
from repro_torch.configs import get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.convert import load_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.server import Engine, Request, _splice_slot
from repro_torch.train.steps import make_batch, make_decode_step, make_prefill_step

ARCHS = ["llama-3.2-vision-11b", "whisper-base"]
MAX_LEN = 64
GQA = dict(num_heads=8, num_kv_heads=2)  # 4 query heads a KV head, head_dim 16


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
        assert set(port) == set(ref)
        return [pr for k in port for pr in _pairs(port[k], ref[k])]
    if isinstance(port, tuple):
        assert len(port) == len(ref)
        return [pr for p, r in zip(port, ref) for pr in _pairs(p, r)]
    return [(port, ref)]


def _frontend(cfg, B, rows=None, seed=0):
    """The family's frontend input as numpy, normal times 0.02: {"img_embed":
    (B, rows or num_image_tokens, frontend_dim)} or {"enc_embed": (B, rows
    or encoder_seq, d)}."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        shape, name = (B, rows or cfg.num_image_tokens, cfg.frontend_dim or cfg.d_model), "img_embed"
    else:
        shape, name = (B, rows or cfg.encoder_seq, cfg.d_model), "enc_embed"
    return {name: (rng.normal(size=shape) * 0.02).astype(np.float32)}


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


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def xattn():
    """One cross-attention layer of the reduced vlm under GQA, the
    reference's weights in both packages."""
    ref_cfg = ref_get_config("llama-3.2-vision-11b").reduced(**GQA)
    cfg = get_config("llama-3.2-vision-11b").reduced(**GQA)
    p = unbox(RL.init_attention(jax.random.PRNGKey(5), ref_cfg, cross=True))[0]
    layer = load_from_numpy(L.Attention(cfg, "cpu"), jax.tree.map(np.asarray, p))
    return ref_cfg, cfg, p, layer


@pytest.mark.parametrize("Sq", [5, 40])  # below and above attn_q_block (32)
def test_cross_attention_without_a_cache_matches(xattn, Sq):
    """Training: k and v from ``kv_src`` (23 rows), no mask, no RoPE."""
    ref_cfg, cfg, p, layer = xattn
    rng = np.random.default_rng(Sq)
    x = rng.normal(size=(2, Sq, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(2, 23, cfg.d_model)).astype(np.float32)
    want, wc = RL.attention_apply(p, jnp.asarray(x), ref_cfg, kv_src=jnp.asarray(src),
                                  causal=False)
    got, gc = L.attention_apply(layer, torch.from_numpy(x), cfg, kv_src=torch.from_numpy(src),
                                causal=False)
    assert wc is None and gc is None
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("source", ["kv_src", "prompt"])
def test_cross_attention_prefill_writes_row_0_and_attends_over_the_whole_cache(xattn, source):
    """Prefill: k and v (from ``kv_src``, or from the queries' own input as
    in the ``Engine``) written at index 0 of a 30-row cache whose other
    rows hold earlier values; the queries attend over all 30 rows,
    unmasked."""
    ref_cfg, cfg, p, layer = xattn
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(2, 23, cfg.d_model)).astype(np.float32) if source == "kv_src" else None
    kc = rng.normal(size=(2, 30, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    want, (wk, wv) = RL.attention_apply(
        p, jnp.asarray(x), ref_cfg, kv_src=None if src is None else jnp.asarray(src),
        cache=(jnp.asarray(kc), jnp.asarray(vc)), cache_index=jnp.zeros((), jnp.int32),
        causal=False)
    cache = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    with torch.inference_mode():
        got, (gk, gv) = L.attention_apply(
            layer, torch.from_numpy(x), cfg,
            kv_src=None if src is None else torch.from_numpy(src), cache=cache, cache_index=0,
            causal=False)
    assert gk is cache[0] and gv is cache[1]  # written in place
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-5, rtol=0)
    n = 23 if source == "kv_src" else 9
    for g, w, before in ((gk, wk, kc), (gv, wv, vc)):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(g.numpy()[:, n:], before[:, n:])


def test_cross_attention_decode_reads_the_cache_as_it_stands(xattn):
    ref_cfg, cfg, p, layer = xattn
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(3, 30, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    want, (wk, _) = RL.attention_apply(p, jnp.asarray(x), ref_cfg,
                                       cache=(jnp.asarray(kc), jnp.asarray(vc)), causal=False)
    cache = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    with torch.inference_mode():
        got, (gk, gv) = L.attention_apply(layer, torch.from_numpy(x), cfg, cache=cache,
                                          causal=False)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gk.numpy(), kc)
    np.testing.assert_array_equal(gv.numpy(), vc)
    np.testing.assert_array_equal(_np(wk), kc)


def test_cross_prefill_longer_than_the_cache_raises(xattn):
    """The reference fails to trace a write past the cache
    (``dynamic_update_slice``); the port raises ValueError."""
    _, cfg, _, layer = xattn
    cache = (torch.zeros(1, 4, cfg.num_kv_heads, cfg.head_dim),) * 2
    with pytest.raises(ValueError, match="fits the cache"), torch.inference_mode():
        L.attention_apply(layer, torch.zeros(1, 3, cfg.d_model), cfg,
                          kv_src=torch.zeros(1, 5, cfg.d_model), cache=cache, cache_index=0,
                          causal=False)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_frontend", [True, False], ids=["frontend", "no_frontend"])
def test_forward_matches_the_reference(lm, with_frontend):
    """No state, S = 40: with the frontend input the cross layers (and
    Whisper's encoder, here over 20 of its 32 frames) run; without it they
    are skipped, as in the reference."""
    ref_cfg, cfg, params, model, _ = lm
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    fe = _frontend(cfg, 2, rows=20 if cfg.family == "encdec" else None) if with_frontend else {}
    want_h, _ = RT.hidden_forward(params, jnp.asarray(toks), ref_cfg,
                                  **{k: jnp.asarray(v) for k, v in fe.items()})
    want_l, _ = RT.forward(params, jnp.asarray(toks), ref_cfg,
                           **{k: jnp.asarray(v) for k, v in fe.items()})
    with torch.inference_mode():
        tfe = {k: torch.from_numpy(v) for k, v in fe.items()}
        got_h, st = T.hidden_forward(model, torch.from_numpy(toks), cfg, **tfe)
        got_l, _ = T.forward(model, torch.from_numpy(toks), cfg, **tfe)
    assert st is None
    np.testing.assert_allclose(got_h.numpy(), _np(want_h), atol=1e-4, rtol=0)
    _close_logits(got_l, want_l)


def test_the_frontend_input_reaches_the_output(lm):
    """The cross layers' source matters: logits with and without it differ
    (on both sides; the forward test holds them equal)."""
    _, cfg, _, model, _ = lm
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12))
                            .astype(np.int32))
    fe = {k: torch.from_numpy(v) for k, v in _frontend(cfg, 1).items()}
    with torch.inference_mode():
        a, _ = T.forward(model, toks, cfg, **fe)
        b, _ = T.forward(model, toks, cfg)
    assert float((a - b).abs().max()) > 1e-3 * float(b.abs().max())


@pytest.mark.parametrize("S,with_frontend", [(6, False), (12, False), (6, True), (40, True)])
def test_prefill_and_decode_chain_matches(lm, S, with_frontend):
    """Prefill of S tokens (with the frontend input: the cross caches from
    the image or the encoder; without it: from the prompt, the Engine's
    path), then 4 greedy decode steps that read the cross caches: logits,
    tokens, and every cache leaf at the end."""
    ref_cfg, cfg, params, model, (rpre, rdec) = lm
    toks = np.random.default_rng(S + 1).integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    fe = _frontend(cfg, 1, rows=20 if cfg.family == "encdec" else None, seed=S) \
        if with_frontend else {}
    want, rst = rpre(params, {"tokens": jnp.asarray(toks),
                              **{k: jnp.asarray(v) for k, v in fe.items()}})
    got, tst = make_prefill_step(cfg, MAX_LEN)(model, {
        "tokens": torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in fe.items()}})
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


@pytest.mark.parametrize("img_tokens", [0, 9])
def test_init_cache_matches_the_reference_layout(lm, img_tokens):
    ref_cfg, cfg, _, _, _ = lm
    st = T.init_cache(cfg, 3, 20, device="cpu", img_tokens=img_tokens)
    ref = RT.init_cache(ref_cfg, 3, 20, img_tokens=img_tokens)
    pairs = _pairs(st.caches, ref.caches)
    assert len(pairs) == len(jax.tree.leaves(ref.caches)) == len(T.cache_leaves(st.caches)) == 4
    for t, r in pairs:
        assert tuple(t.shape) == r.shape and t.dtype == getattr(torch, str(r.dtype))
        assert not t.any()
    assert st.index == int(ref.index) == 0


def test_converter_places_every_leaf_and_refuses_extras(lm):
    """Each parameter holds the reference leaf of its path (the vlm's self
    layers indexed by cycle and layer, its cross layers by cycle; Whisper's
    encoder and decoder layers by layer), and a leaf the model has no
    place for raises."""
    _, cfg, params, model, _ = lm
    tree = jax.tree.map(np.asarray, params)
    if cfg.family == "vlm":
        placed = [(model.blocks[1].self[0].attn.wq, tree["blocks"]["self"]["attn"]["wq"][1, 0]),
                  (model.blocks[1].cross.xattn.wk, tree["blocks"]["cross"]["xattn"]["wk"][1]),
                  (model.blocks[0].cross.lnx.w, tree["blocks"]["cross"]["lnx"]["w"][0]),
                  (model.img_proj, tree["img_proj"])]
        assert model.blocks[0].cross.attn is None and model.blocks[0].cross.ln1 is None
    else:
        placed = [(model.enc_blocks[1].mlp.b1, tree["enc_blocks"]["mlp"]["b1"][1]),
                  (model.dec_blocks[1].xattn.wv, tree["dec_blocks"]["xattn"]["wv"][1]),
                  (model.dec_blocks[0].lnx.b, tree["dec_blocks"]["lnx"]["b"][0]),
                  (model.enc_ln.b, tree["enc_ln"]["b"]), (model.enc_pos, tree["enc_pos"]),
                  (model.embed.pos, tree["embed"]["pos"])]
        assert model.blocks is None and model.enc_blocks[0].xattn is None
    for p, want in placed:
        np.testing.assert_array_equal(p.detach().numpy(), want)
    tree["final_ln"]["extra"] = np.zeros(cfg.d_model, np.float32)
    with pytest.raises(ValueError, match="extra"):
        lm_params_from_numpy(tree, cfg, device="cpu")


def _ref_names(params, cfg):
    """The port's parameter names for the reference tree's leaves: one per
    cycle of a ``blocks`` leaf (per (cycle, layer) of the vlm's ``self``
    leaves), one per layer of an ``enc_blocks`` or ``dec_blocks`` leaf."""
    nc = T._num_cycles(cfg)
    stacks = {"blocks": nc, "enc_blocks": cfg.encoder_layers, "dec_blocks": cfg.num_layers}
    names = set()
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        if keys[0] not in stacks:
            names.add(".".join(keys))
        elif keys[1] == "self":
            names.update(f"blocks.{i}.self.{j}.{'.'.join(keys[2:])}"
                         for i in range(nc) for j in range(cfg.cross_attn_every - 1))
        else:
            names.update(f"{keys[0]}.{i}.{'.'.join(keys[1:])}" for i in range(stacks[keys[0]]))
    return names


def test_init_params_follows_the_reference_rule_leaf_by_leaf(lm):
    """The reference's paths; norm weights one, biases (LayerNorm's, the
    GELU MLP's) zero; projections truncated normals within two scales,
    ``wo`` by (H hd)^-0.5, ``w2`` by d_ff^-0.5, the embedding by 1, the
    rest by the fan-in of their leading axis: ``img_proj`` by
    frontend_dim^-0.5, ``enc_pos`` by encoder_seq^-0.5, ``embed.pos`` by
    learned_pos^-0.5 (``pp.winit``); one seed, one model."""
    _, cfg, params, _, _ = lm
    a = T.init_params(cfg, seed=3, device="cpu")
    b = T.init_params(cfg, seed=3, device="cpu")
    assert {n for n, _ in a.named_parameters()} == _ref_names(params, cfg)
    H, hd = cfg.num_heads, cfg.head_dim
    scale = {"wo": (H * hd) ** -0.5, "w2": cfg.d_ff**-0.5, "table": 1.0}
    seen = set()
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        p = p.detach()
        assert torch.equal(p, q)
        leaf = n.rsplit(".", 1)[-1]
        seen.add(leaf)
        if leaf == "w":
            assert bool((p == 1).all()), n
        elif leaf.startswith("b"):
            assert not p.any(), n
        else:
            s = scale.get(leaf) or p.shape[0] ** -0.5
            assert float(p.abs().max()) <= 2 * s * (1 + 1e-6), n
            assert 0.5 * s < float(p.float().std()) < s, n
    family = {"vlm": {"img_proj", "wq", "w3"}, "encdec": {"enc_pos", "pos", "b1", "b2", "b"}}
    assert family[cfg.family] <= seen


@pytest.mark.parametrize("arch", ARCHS + ["qwen2-1.5b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_make_batch_matches_batch_struct(arch, kind, reduced):
    """Names in order, shapes and dtypes of ``batch_struct`` (the full
    configs' frontends in bfloat16); tokens in the vocabulary, the
    frontend rows normal times 0.02."""
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    if reduced:
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    want = batch_struct(ref_cfg, RefShapeSpec("t", 8, 2, kind))
    got = make_batch(cfg, ShapeSpec("t", 8, 2, kind), torch.Generator().manual_seed(0))
    assert list(got) == list(want)
    for name, sds in want.items():
        t = got[name]
        assert tuple(t.shape) == sds.shape and str(t.dtype) == f"torch.{sds.dtype}", name
        if t.dtype == torch.int32:
            assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
        else:
            assert 0.015 < float(t.float().std()) < 0.025, name


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_engine_tokens_equal_the_reference_engine(lm):
    """Six requests of four prompt lengths (each within the vlm's 16 cross
    rows) over three slots, with refills: every request's tokens equal
    the reference engine's, with the reference's cross prefill from the
    prompt and, in the vlm, its splice of the self caches into row 0."""
    ref_cfg, cfg, params, model, _ = lm
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 5, 14, 12, 5, 3)]
    ref = RefEngine(ref_cfg, params, slots=3, max_len=MAX_LEN)
    eng = Engine(cfg, model, slots=3, max_len=MAX_LEN)
    for rid, p in enumerate(prompts):
        ref.submit(RefRequest(rid=rid, prompt=p, max_new=5))
        eng.submit(Request(rid=rid, prompt=p, max_new=5))
    want = {r.rid: r.out for r in ref.run_until_drained()}
    got = {r.rid: r.out for r in eng.run_until_drained()}
    assert got == want
    assert eng.state.index == int(ref.state.index)
    for t, r in _pairs(eng.state.caches, ref.state.caches):
        _close_state(t, r)


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


def test_vlm_splice_files_self_caches_in_row_0_as_the_reference_does():
    """ROADMAP Queue 3: the reference's ``_splice_slot`` updates every
    cache leaf at axis 1, which is the layer axis of the vlm's self caches
    (cycles, n_self, B, S_max, KH, hd): JAX clamps the slot to 0 there,
    and a request admitted to slot 2 of 3 has its self-attention keys and
    values written to batch row 0, rows 1 and 2 left zero. Its cross
    caches (cycles, B, rows, ...) go to row 2. The port does the same.
    Whisper's caches are stacked once and land in their slot."""
    tst, rst, t1, _ = _prefilled(_build("llama-3.2-vision-11b"), 3, 2, 9)
    for side, caches in (("port", tst.caches), ("reference", rst.caches)):
        for leaf, want in zip(caches["self"], t1.caches["self"]):
            leaf = _np(leaf)
            assert leaf.shape[2] == 3, side
            np.testing.assert_allclose(leaf[:, :, 0], want[:, :, 0].numpy(), atol=1e-5,
                                       err_msg=side)
            assert np.abs(leaf[:, :, 0, :9]).max() > 0 and not leaf[:, :, 1:].any(), side
        for leaf, want in zip(caches["cross"], t1.caches["cross"]):
            leaf = _np(leaf)
            np.testing.assert_allclose(leaf[:, 2], want[:, 0].numpy(), atol=1e-5, err_msg=side)
            assert not leaf[:, :2].any(), side
    tst, _, t1, _ = _prefilled(_build("whisper-base"), 3, 1, 9)
    for dst, src in zip(T.cache_leaves(tst.caches), T.cache_leaves(t1.caches)):
        assert torch.equal(dst[:, 1], src[:, 0])
        assert not dst[:, 0].any() and not dst[:, 2].any()


def test_engine_prefill_cross_attends_over_the_prompt_and_zero_rows_as_the_reference_does(lm):
    """ROADMAP Queue 3: the ``Engine`` prefills with prompts only, so each
    cross layer projects its keys and values from the prompt's own hidden
    states, writes them at row 0 of the cross cache (num_image_tokens or
    encoder_seq rows) and attends over every row, the zero rows behind the
    prompt included. On both sides: the cross caches hold the prompt's S
    rows and zeros after them, and a cross cache of exactly S rows gives
    other logits (the zero rows take softmax weight)."""
    ref_cfg, cfg, params, model, (rpre, _) = lm
    S = 7
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    want, rst = rpre(params, {"tokens": jnp.asarray(toks)})
    got, tst = make_prefill_step(cfg, MAX_LEN)(model, {"tokens": torch.from_numpy(toks)})
    for t, r in _pairs(tst.caches["cross"], rst.caches["cross"]):
        _close_state(t, r)
        t = t.numpy()
        assert np.abs(t[:, :, :S]).max(axis=(2, 3, 4)).min() > 0  # every layer wrote its rows
        assert not t[:, :, S:].any()
    rows = {"vlm": "num_image_tokens", "encdec": "encoder_seq"}[cfg.family]
    ref_s = dataclasses.replace(ref_cfg, **{rows: S})
    cfg_s = dataclasses.replace(cfg, **{rows: S})
    want_s, _ = jax.jit(ref_prefill_step(ref_s, MAX_LEN))(params, {"tokens": jnp.asarray(toks)})
    got_s, _ = make_prefill_step(cfg_s, MAX_LEN)(model, {"tokens": torch.from_numpy(toks)})
    _close_logits(got_s, want_s)
    for a, b in ((got, got_s), (_np(want), _np(want_s))):
        a, b = np.asarray(a, dtype=np.float32), np.asarray(b, dtype=np.float32)
        assert np.abs(a - b).max() > 1e-3 * np.abs(b).max()


def test_serve_launcher_runs_both_families(lm):
    """``launch/serve.py --preset smoke --device cpu``: every request done
    (prompts of 8-15 tokens, within the vlm's 16 cross rows)."""
    _, cfg, _, _, _ = lm
    argv = ["--arch", cfg.name, "--preset", "smoke", "--device", "cpu", "--requests", "3",
            "--max-new", "4", "--max-len", "64"]
    assert serve.main(argv) == 3


def test_a_served_prompt_longer_than_the_cross_cache_raises():
    """The reference's ``Engine`` fails to trace a prompt longer than the
    vlm's cross cache (``dynamic_update_slice``); the port's raises
    ValueError."""
    _, cfg, _, model, _ = _build("llama-3.2-vision-11b")
    eng = Engine(cfg, model, slots=1, max_len=MAX_LEN)
    eng.submit(Request(rid=0, prompt=np.zeros(cfg.num_image_tokens + 1, np.int32), max_new=2))
    with pytest.raises(ValueError, match="fits the cache"):
        eng.run_until_drained()
