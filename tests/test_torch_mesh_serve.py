"""Serving over a (data, model) mesh of ranks: the port's ``Engine`` with
``mesh=`` against the reference's ``Engine`` under ``shd.use_mesh`` on
the same mesh, and against the port's one-device engine.

The reference runs once, in a subprocess with 8 forced host devices, on
Auto-axis meshes (``torch_sharded_harness.REF_LM``); the port runs in a
gloo group of 4 spawned CPU ranks on 2x2 and 1x4, every rank returning
the whole result (all ranks must agree). Models: the six families'
reduced float32 configs from the reference's initial weights; the engine
has 4 slots of 64 positions and serves 6 prompts of 8 and 13 tokens, 6
new tokens each, so slots are refilled and decode shares one index (the
reference's fault, kept). Both engines' prefill and tick logits come
from their ``make_prefill_step`` / ``make_decode_step`` on the mesh.

Tolerances: tokens equal; logits within 1e-5 of max |logit| of the
reference's on the mesh and of the port's one-device engine's (float32:
the ranks' sums run in another order), except xlstm's against the
reference, held to 1e-4 of max |logit|: the port's one-device xlstm
engine is 3.3e-5 off the reference's at the 13-token prefill (mLSTM's
normaliser |q . n| + 1e-6 amplifies float32 rounding), the conditioning
``tests/test_torch_recurrent_lm.py`` states and holds; its mesh engine
keeps 1e-5 of the port's one-device engine. The hybrid and vlm engines'
final caches within 1e-5 of their leaf's max; the splice and the
distributed argmax exact. The moe family serves on 1x4; on 2x2 the reference's
expert-sharded ``shard_map`` refuses the engine's one-row prefill (batch
1 over a data axis of 2), and the port raises ``ValueError`` there too.
"""
import os

import numpy as np
import pytest
import torch

from torch_sharded_harness import (REF_LM, as_json, loads, nest, run_port, run_reference,
                                   save_rank)

ARCHS = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "zamba2-2.7b", "xlstm-350m",
         "llama-3.2-vision-11b", "whisper-base")
MESHES = ("2x2", "1x4")
SLOTS, MAX_LEN, MAX_NEW = 4, 64, 6
PROMPT_LENS = (8, 13, 8, 13, 8, 13)
# decode positions: 1x4's block boundaries (16, 32) and 2x2's (32), the
# last row, and two past S_max (the write is dropped)
INDICES = (15, 16, 32, 63, 64, 70)
STATE_ARCHS = ("zamba2-2.7b", "llama-3.2-vision-11b")  # the twice-stacked splice
TOL = 1e-5
REF_TOL = {"xlstm-350m": 1e-4}  # its one-device conditioning (module docstring)

REFERENCE = """
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.models import transformer as RT
from repro.models.params import unbox
from repro.serving.server import Engine, Request
from repro.train import steps as RS

prompts = [inputs[f"prompt{i}"] for i in range(len(PROMPT_LENS))]
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    params, _ = unbox(RT.init_params(jax.random.PRNGKey(0), cfg))
    flat(f"{arch}/params", params)
    for tag in MESHES:
        with shd.use_mesh(mesh(tag)):
            eng = Engine(cfg, params, slots=SLOTS, max_len=MAX_LEN)
            log = []
            def pre(p, b, f=eng._prefill):
                r = f(p, b)
                log.append(np.asarray(r[0]))
                return r
            def dec(p, s, t, f=eng._decode):
                r = f(p, s, t)
                log.append(np.asarray(r[0]))
                return r
            eng._prefill, eng._decode = pre, dec
            for i, pr in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=pr, max_new=MAX_NEW))
            try:
                done = eng.run_until_drained()
            except ValueError as e:
                save_json(f"{arch}/{tag}/error", str(e))
                continue
            out[f"{arch}/{tag}/tokens"] = np.asarray([r.out for r in sorted(done, key=lambda r: r.rid)])
            for j, lg in enumerate(log):
                out[f"{arch}/{tag}/logits/{j}"] = lg
            if arch in STATE_ARCHS:
                flat(f"{arch}/{tag}/state", eng.state.caches)

cfg = get_config("qwen2-1.5b").reduced()
params, _ = unbox(RT.init_params(jax.random.PRNGKey(0), cfg))
for tag in MESHES:
    with shd.use_mesh(mesh(tag)):
        prefill = jax.jit(RS.make_prefill_step(cfg, MAX_LEN))
        decode = jax.jit(RS.make_decode_step(cfg))
        lg, st = prefill(params, {"tokens": jnp.asarray(inputs["batch"])})
        out[f"steps/{tag}/prefill"] = np.asarray(lg)
        for i, at in enumerate(INDICES):
            st = RT.StepState(st.caches, jnp.int32(at))
            lg, nxt, st = decode(params, st, jnp.asarray(inputs[f"step{i}"]))
            out[f"steps/{tag}/{at}"] = np.asarray(lg)
"""


def _write_inputs(workdir):
    rng = np.random.default_rng(27)
    d = {f"prompt{i}": rng.integers(0, 512, size=n).astype(np.int32)
         for i, n in enumerate(PROMPT_LENS)}
    d["batch"] = rng.integers(0, 512, (SLOTS, 8)).astype(np.int32)
    for i in range(len(INDICES)):
        d[f"step{i}"] = rng.integers(0, 512, (SLOTS, 1)).astype(np.int32)
    np.savez(os.path.join(str(workdir), "inputs.npz"), **d)


def _serve(cfg, params, mesh, prompts):
    """(tokens (requests, MAX_NEW), logits of every prefill and tick, the
    engine) of the port's engine."""
    from repro_torch.serving.server import Engine, Request

    eng = Engine(cfg, params, slots=SLOTS, max_len=MAX_LEN, mesh=mesh)
    log = []

    def logged(fn):
        def run(*a):
            out = fn(*a)
            log.append(out[0].float().numpy().copy())
            return out
        return run

    eng._prefill, eng._decode = logged(eng._prefill), logged(eng._decode)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
    done = eng.run_until_drained()
    toks = np.asarray([r.out for r in sorted(done, key=lambda r: r.rid)])
    return toks, log, eng


def _flat_state(state, mesh, prefix):
    """{"<prefix>/<path>": whole float32 array} of a state's cache leaves,
    gathered from the ranks' blocks (paths as the reference's ``flat``)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as T

    out = {}

    def walk(node, spec, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], spec[k], path + (k,))
        elif isinstance(node, tuple):
            for i, (n, s) in enumerate(zip(node, spec)):
                walk(n, s, path + (str(i),))
        else:
            out[f"{prefix}/{'/'.join(path)}"] = shd.gather(node, spec.entries, mesh).float() \
                .numpy().copy()

    assert isinstance(state.specs, (dict, tuple)) and T.cache_leaves(state.specs)
    walk(state.caches, state.specs, ())
    return out


def _splice_cases(mesh, prefix):
    """``_splice_slot`` on the mesh's blocks of random states against the
    one-device splice of the whole states, gathered (slots 0 and 2): the
    once-stacked leaves land in the slot, the twice-stacked ones in batch
    row 0, which lives on data rank 0."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.serving.server import _splice_slot
    from repro_torch.train.steps import mesh_rules

    out = {}
    for arch in ("qwen2-1.5b", "zamba2-2.7b", "llama-3.2-vision-11b"):
        cfg = get_config(arch).reduced()
        rules = mesh_rules(cfg)
        gen = torch.Generator().manual_seed(5)

        def rand(st):
            for t in T.cache_leaves(st.caches):
                t.copy_(torch.randn(t.shape, generator=gen))
            return st

        for slot in (0, 2):
            big = rand(T.init_cache(cfg, SLOTS, MAX_LEN, device="cpu"))
            one = rand(T.init_cache(cfg, 1, MAX_LEN, device="cpu"))
            mb = T.init_cache(cfg, SLOTS, MAX_LEN, device="cpu", mesh=mesh, rules=rules)
            mo = T.init_cache(cfg, 1, MAX_LEN, device="cpu", mesh=mesh, layout_batch=SLOTS,
                              rules=rules)
            for st, whole in ((mb, big), (mo, one)):
                for t, w, sp in zip(T.cache_leaves(st.caches), T.cache_leaves(whole.caches),
                                    T.cache_leaves(st.specs)):
                    t.copy_(shd.shard_of(w, sp.entries, mesh))
            want = _splice_slot(big, one, slot)
            got = _splice_slot(mb, mo, slot, mesh)
            for i, (g, w, sp) in enumerate(zip(T.cache_leaves(got.caches),
                                               T.cache_leaves(want.caches),
                                               T.cache_leaves(got.specs))):
                whole = shd.gather(g, sp.entries, mesh)
                out[f"{prefix}/{arch}/{slot}/{i}"] = np.asarray(bool(torch.equal(whole, w)))
    return out


def _argmax_ties(mesh):
    """The distributed argmax of logits with planted ties, vocabulary
    split on ``model``, against ``torch.argmax`` of the whole rows."""
    from repro_torch.distributed import sharding as shd

    V = 16
    x = torch.zeros(4, V)
    x[0, [3, 12]] = 5.0  # a tie across blocks
    x[1, [9, 10]] = 2.0  # a tie inside one block
    x[2] = 1.0  # every column equal
    x[3, [7, 8, 15]] = 4.0  # a tie on a block boundary
    start, stop = shd.block_range(V, ("model",), mesh)
    got = shd.vocab_argmax(x[:, start:stop], start, ("model",), mesh)
    return got.numpy(), torch.argmax(x, dim=-1).numpy()


def _port_ranks(rank, world, workdir):
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    with np.load(os.path.join(str(workdir), "ref.npz")) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(os.path.join(str(workdir), "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    prompts = [inputs[f"prompt{i}"] for i in range(len(PROMPT_LENS))]
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        tree = nest(ref, f"{arch}/params")
        toks, logits, _ = _serve(cfg, lm_params_from_numpy(tree, cfg, device="cpu"), None,
                                 prompts)
        out[f"{arch}/single/tokens"] = toks
        for j, lg in enumerate(logits):
            out[f"{arch}/single/logits/{j}"] = lg
        for tag in MESHES:
            D, M = (int(x) for x in tag.split("x"))
            mesh = shd.make_rank_mesh(D, M, device="cpu")
            params = lm_params_from_numpy(tree, cfg, device="cpu", mesh=mesh)
            try:
                toks, logits, eng = _serve(cfg, params, mesh, prompts)
            except ValueError as e:
                out[f"{arch}/{tag}/error"] = as_json(str(e))
                continue
            out[f"{arch}/{tag}/tokens"] = toks
            for j, lg in enumerate(logits):
                out[f"{arch}/{tag}/logits/{j}"] = lg
            if arch in STATE_ARCHS:
                out.update(_flat_state(eng.state, mesh, f"{arch}/{tag}/state"))
    cfg = get_config("qwen2-1.5b").reduced()
    tree = nest(ref, "qwen2-1.5b/params")
    for tag in MESHES:
        D, M = (int(x) for x in tag.split("x"))
        mesh = shd.make_rank_mesh(D, M, device="cpu")
        params = lm_params_from_numpy(tree, cfg, device="cpu", mesh=mesh)
        lg, st = make_prefill_step(cfg, MAX_LEN, mesh=mesh)(
            params, {"tokens": torch.from_numpy(inputs["batch"])})
        out[f"steps/{tag}/prefill"] = lg.numpy()
        decode = make_decode_step(cfg, mesh=mesh)
        for i, at in enumerate(INDICES):
            lg, _, st = decode(params, T.StepState(st.caches, at, st.specs),
                               torch.from_numpy(inputs[f"step{i}"]))
            out[f"steps/{tag}/{at}"] = lg.numpy()
        out.update(_splice_cases(mesh, f"splice/{tag}"))
        got, want = _argmax_ties(mesh)
        out[f"argmax/{tag}/got"], out[f"argmax/{tag}/want"] = got, want
    save_rank(workdir, world, rank, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh_serve")
    _write_inputs(wd)
    consts = (f"ARCHS = {ARCHS!r}\nMESHES = {MESHES!r}\nSLOTS, MAX_LEN, MAX_NEW = "
              f"{SLOTS}, {MAX_LEN}, {MAX_NEW}\nPROMPT_LENS = {PROMPT_LENS!r}\n"
              f"INDICES = {INDICES!r}\nSTATE_ARCHS = {STATE_ARCHS!r}\n")
    ref = run_reference(consts + REF_LM + REFERENCE, wd)
    return ref, run_port(_port_ranks, wd, worlds=(4,))[4]


def _close_max(got, want, what, tol=TOL):
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


SERVED = [(a, t) for a in ARCHS for t in MESHES if not (a == "qwen3-moe-235b-a22b" and t == "2x2")]


@pytest.mark.parametrize("arch,tag", SERVED)
def test_mesh_engine_tokens_match_reference_and_one_device(runs, arch, tag):
    ref, port = runs
    got = port[f"{arch}/{tag}/tokens"]
    assert got.shape == (len(PROMPT_LENS), MAX_NEW)
    np.testing.assert_array_equal(got, ref[f"{arch}/{tag}/tokens"])
    np.testing.assert_array_equal(got, port[f"{arch}/single/tokens"])


@pytest.mark.parametrize("arch,tag", SERVED)
def test_mesh_engine_logits_match_reference_and_one_device(runs, arch, tag):
    """Every prefill's and tick's logits, in the engine's order."""
    ref, port = runs
    keys = sorted((k for k in ref if k.startswith(f"{arch}/{tag}/logits/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    assert keys and len(keys) == len([k for k in port if k.startswith(f"{arch}/{tag}/logits/")])
    for k in keys:
        _close_max(port[k], ref[k], k, REF_TOL.get(arch, TOL))
        _close_max(port[k], port[k.replace(f"/{tag}/", "/single/")], f"{k} vs one device")


@pytest.mark.parametrize("tag", MESHES)
def test_moe_engine_on_2x2_raises_as_the_reference(runs, tag):
    """The reference's expert-sharded layer takes the batch split over
    ('data',); the engine's one-row prefill does not split 2 ways, and
    both sides refuse it (ROADMAP Queue 3). On 1x4 both serve."""
    ref, port = runs
    key = f"qwen3-moe-235b-a22b/{tag}/error"
    if tag == "1x4":
        assert key not in ref and key not in port
        return
    assert "not evenly divisible" in loads(ref[key]), loads(ref[key])
    assert "does not evenly divide 1" in loads(port[key]), loads(port[key])


@pytest.mark.parametrize("tag", MESHES)
def test_decode_at_block_boundaries_and_past_s_max(runs, tag):
    """A prefill of 4 rows, then decodes at the cache's block boundaries,
    its last row and two positions past S_max (the write is dropped)."""
    ref, port = runs
    _close_max(port[f"steps/{tag}/prefill"], ref[f"steps/{tag}/prefill"], "prefill")
    for at in INDICES:
        _close_max(port[f"steps/{tag}/{at}"], ref[f"steps/{tag}/{at}"], f"decode at {at}")


@pytest.mark.parametrize("arch", STATE_ARCHS)
@pytest.mark.parametrize("tag", MESHES)
def test_mesh_engine_state_matches_reference(runs, arch, tag):
    """The engine's caches after the run: the Mamba2 states and the vlm's
    self caches spliced into batch row 0, as the reference does."""
    ref, port = runs
    keys = [k for k in ref if k.startswith(f"{arch}/{tag}/state/")]
    assert keys and sorted(keys) == sorted(k for k in port if k.startswith(f"{arch}/{tag}/state/"))
    for k in keys:
        _close_max(port[k], ref[k], k)


@pytest.mark.parametrize("tag", MESHES)
def test_splice_on_a_mesh_equals_the_one_device_splice(runs, tag):
    _, port = runs
    keys = [k for k in port if k.startswith(f"splice/{tag}/")]
    assert len(keys) == (2 + 4 + 4) * 2  # (dense, hybrid, vlm leaves) x slots
    assert all(bool(port[k]) for k in keys), [k for k in keys if not bool(port[k])]


@pytest.mark.parametrize("tag", MESHES)
def test_distributed_argmax_keeps_the_first_index_on_ties(runs, tag):
    _, port = runs
    np.testing.assert_array_equal(port[f"argmax/{tag}/got"], port[f"argmax/{tag}/want"])
    np.testing.assert_array_equal(port[f"argmax/{tag}/want"], [3, 9, 0, 7])


def test_serve_launcher_over_a_mesh():
    """``launch/serve.py --mesh host:2x2`` spawns four ranks, checks that
    their tokens agree and returns rank 0's count."""
    from repro_torch.launch import serve as serve_mod

    n = serve_mod.main(["--arch", "qwen2-1.5b", "--preset", "smoke", "--device", "cpu",
                        "--mesh", "host:2x2", "--requests", "5", "--max-new", "4",
                        "--max-len", "64"])
    assert n == 5
    with pytest.raises(ValueError, match="256 ranks"):
        serve_mod.main(["--arch", "qwen2-1.5b", "--device", "cpu", "--mesh", "prod"])
