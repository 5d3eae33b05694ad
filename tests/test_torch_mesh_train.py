"""The dense and MoE LMs over a (data, model) mesh of ranks: the port's
sharded train step and MoE branches against the reference's own
sharded runs and against the port's single-device step (the launcher
over a mesh is in ``test_torch_train_infra.py``).

The reference runs once, in a subprocess with 8 forced host devices, on
meshes it builds with ``axis_types=(AxisType.Auto, ...)`` (JAX 0.9's
``jax.make_mesh`` defaults to ``Explicit`` axes, which the reference's
``with_sharding_constraint`` refuses; ROADMAP Queue 3). The port runs in
gloo groups of 4 and 8 spawned CPU ranks (``torch_sharded_harness``):
2x2 and 1x4 (the reduced qwen2's 2 KV heads do not split 4 ways: the
fallback that gathers ``wk``/``wv``) on 4, 4x2 and the weight-stationary
2x4 on 8. Every rank gathers its blocks and returns the whole result, and
all ranks must agree bit for bit.

Models: ``qwen2-1.5b`` and ``qwen3-moe-235b-a22b`` reduced (float32),
B 4 x S 64 (the reference takes its blockwise attention), loss chunk 24,
from the reference's initial weights. Tolerances, as
``test_torch_train_step.py``: losses rtol 1e-5; AdamW's moments within
1e-5 of their leaf's max (the key bias ``bk``, whose gradient is rounding
noise, of ``wk``'s); each parameter's update from the initial weights
after k AdamW steps within ``UPDATE_RTOL`` of the wanted update in norm
(measured at most 7.2e-5 over the meshes, steps and both references; a
skipped update reads 1 and a flipped one 2), ``bk``'s update, rounding
noise about lr in size, within 1.01 sum(lr); Adafactor's parameters and
factors within 1e-5 of their leaf's max; MoE outputs within 1e-5 of
their max.
"""
import os

import numpy as np
import pytest
import torch

from torch_sharded_harness import gathered_state as _gathered_state
from torch_sharded_harness import nest as _nest
from torch_sharded_harness import ref_leaf as _ref_leaf
from torch_sharded_harness import ref_opt as _ref_opt
from torch_sharded_harness import REF_LM, run_port, run_reference, save_rank

B, SEQ, STEPS = 4, 64, 3
CFG_KW = dict(loss_chunk=24)
OC_KW = dict(warmup_steps=2, total_steps=20)
DENSE_MESHES = {4: ("2x2", "1x4"), 8: ("4x2",)}
MOE_T = 16  # tokens a row of the MoE layer's input
TOL = 1e-5
LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-3

REFERENCE = """
import dataclasses
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.models import layers as L
from repro.models import transformer as RT
from repro.models.params import unbox
from repro.train import optimizer as RO, steps as RS

batches = [{k: jnp.asarray(inputs[f"{k}{i}"]) for k in ("tokens", "labels")} for i in range(3)]

# the dense family: AdamW, one device and three meshes
cfg = get_config("qwen2-1.5b").reduced(loss_chunk=24)
params, _ = unbox(RT.init_params(jax.random.PRNGKey(0), cfg))
flat("dense/init", params)
oc = RO.OptConfig(kind="adamw", warmup_steps=2, total_steps=20)
step = RS.make_train_step(cfg, oc)
for tag in ("single", "2x2", "1x4", "4x2"):
    ctx = shd.use_mesh(mesh(tag)) if tag != "single" else contextlib.nullcontext()
    with ctx:
        s = RS.TrainState(params, RO.init_opt_state(params, oc))
        f = jax.jit(step)
        losses = []
        for i, b in enumerate(batches):
            s, m = f(s, b)
            losses.append(float(m["loss"]))
            if i in (0, 2):
                flat(f"dense/{tag}/s{i + 1}/params", s.params)
                flat(f"dense/{tag}/s{i + 1}/m", s.opt.m)
                flat(f"dense/{tag}/s{i + 1}/v", s.opt.v)
        out[f"dense/{tag}/loss"] = np.asarray(losses)

# the moe family: the layer's branches, and one Adafactor step on 2x2
mcfg = get_config("qwen3-moe-235b-a22b").reduced(loss_chunk=24)
mp, _ = unbox(L.init_moe(jax.random.PRNGKey(1), mcfg))
flat("moe/layer", mp)
x = jnp.asarray(inputs["moe_x"])
for name, c in (("cf8", mcfg), ("cf1", dataclasses.replace(mcfg, capacity_factor=1.0))):
    out[f"moe/{name}/single"] = np.asarray(L.moe_apply(mp, x, c))
    with shd.use_mesh(mesh("2x2")):
        out[f"moe/{name}/2x2"] = np.asarray(jax.jit(lambda p, x: L.moe_apply(p, x, c))(mp, x))
ws = dataclasses.replace(mcfg, moe_weight_stationary_decode=True)
xd = jnp.asarray(inputs["moe_xd"])
out["moe/ws/oracle"] = np.asarray(L.moe_apply(mp, xd, dataclasses.replace(ws, moe_dispatch="dense")))
with shd.use_mesh(mesh("2x4")):
    out["moe/ws/2x4"] = np.asarray(jax.jit(lambda p, x: L.moe_apply(p, x, ws))(mp, xd))
mparams, _ = unbox(RT.init_params(jax.random.PRNGKey(2), mcfg))
flat("moelm/init", mparams)
aoc = RO.OptConfig(kind="adafactor", warmup_steps=2, total_steps=20)
with shd.use_mesh(mesh("2x2")):
    s = RS.TrainState(mparams, RO.init_opt_state(mparams, aoc))
    s, m = jax.jit(RS.make_train_step(mcfg, aoc))(s, batches[0])
out["moelm/2x2/loss"] = np.asarray([float(m["loss"])])
flat("moelm/2x2/params", s.params)
flat("moelm/2x2/v", s.opt.v)
"""


def _write_inputs(workdir):
    rng = np.random.default_rng(26)
    d = {}
    for i in range(3):
        d[f"tokens{i}"] = rng.integers(0, 512, (B, SEQ)).astype(np.int32)
        labels = rng.integers(0, 512, (B, SEQ)).astype(np.int32)
        labels[1, : 7 + i] = -1
        d[f"labels{i}"] = labels
    d["moe_x"] = rng.standard_normal((4, MOE_T, 64)).astype(np.float32)
    d["moe_xd"] = rng.standard_normal((4, 1, 64)).astype(np.float32)
    np.savez(os.path.join(str(workdir), "inputs.npz"), **d)


def _batches(workdir):
    with np.load(os.path.join(str(workdir), "inputs.npz")) as z:
        return [{k: torch.from_numpy(z[f"{k}{i}"].copy()) for k in ("tokens", "labels")}
                for i in range(3)]


def _port_ranks(rank, world, workdir):
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import param_specs
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import make_train_step, mesh_rules

    with np.load(os.path.join(str(workdir), "ref.npz")) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(os.path.join(str(workdir), "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    batches = _batches(workdir)
    out = {}
    cfg = get_config("qwen2-1.5b").reduced(**CFG_KW)
    oc = OptConfig(kind="adamw", **OC_KW)
    for tag in DENSE_MESHES[world]:
        D, M = (int(x) for x in tag.split("x"))
        mesh = shd.make_rank_mesh(D, M, device="cpu")
        state = train_state_from_numpy(_nest(ref, "dense/init"), _ref_opt(ref, "dense/init", "adamw"),
                                       cfg, device="cpu", mesh=mesh)
        step = make_train_step(cfg, oc, mesh=mesh)
        losses = []
        for i, b in enumerate(batches):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            if i in (0, 2):
                out.update(_gathered_state(state, cfg, mesh, f"dense/{tag}/s{i + 1}"))
        out[f"dense/{tag}/loss"] = np.asarray(losses)
        # every rank's replicated leaves are equal bit for bit
        specs = param_specs(cfg, mesh, mesh_rules(cfg))
        for n, p in state.params.named_parameters():
            if not shd.spec_axes(specs[n]):
                lo = shd.all_reduce(p.detach(), mesh.axis_names, mesh, op="max")
                assert torch.equal(lo, p.detach()), n
    if world == 4:
        import dataclasses

        mesh = shd.make_rank_mesh(2, 2, device="cpu")
        mcfg = get_config("qwen3-moe-235b-a22b").reduced(**CFG_KW)
        layer = _moe_layer(ref, mcfg, mesh)
        x = torch.from_numpy(inputs["moe_x"])
        for name, c in (("cf8", mcfg), ("cf1", dataclasses.replace(mcfg, capacity_factor=1.0))):
            with shd.use_mesh(mesh), torch.no_grad():
                y = L.moe_apply(layer, shd.shard_of(x, ("data",), mesh), c)
            out[f"moe/{name}/2x2"] = shd.gather(y, ("data",), mesh).numpy()
        # moe_combine_sharded over each axis (tests/test_sharded.py's case)
        rng = np.random.default_rng(0)
        T_, k, d = 37, 2, 16
        tok = torch.arange(T_, dtype=torch.int32).repeat_interleave(k)
        rows = torch.from_numpy(rng.standard_normal((T_ * k, d)).astype(np.float32))
        gw = torch.from_numpy(rng.random(T_ * k).astype(np.float32))
        for axis in ("data", "model"):
            out[f"combine/{axis}"] = L.moe_combine_sharded(tok, rows, gw, T_, mesh, axis).numpy()
        # one Adafactor step of the MoE LM
        aoc = OptConfig(kind="adafactor", **OC_KW)
        state = train_state_from_numpy(_nest(ref, "moelm/init"),
                                       _ref_opt(ref, "moelm/init", "adafactor"), mcfg,
                                       device="cpu", mesh=mesh)
        state, m = make_train_step(mcfg, aoc, mesh=mesh)(state, batches[0])
        out["moelm/2x2/loss"] = np.asarray([float(m["loss"])])
        out.update(_gathered_state(state, mcfg, mesh, "moelm/2x2"))
    if world == 8:
        import dataclasses

        mesh = shd.make_rank_mesh(2, 4, device="cpu")
        mcfg = get_config("qwen3-moe-235b-a22b").reduced(**CFG_KW)
        ws = dataclasses.replace(mcfg, moe_weight_stationary_decode=True)
        layer = _moe_layer(ref, mcfg, mesh)
        xd = torch.from_numpy(inputs["moe_xd"])
        with shd.use_mesh(mesh), torch.no_grad():
            y = L.moe_apply(layer, shd.shard_of(xd, ("data",), mesh), ws)
        out["moe/ws/2x4"] = shd.gather(y, ("data",), mesh).numpy()
    save_rank(workdir, world, rank, out)


def _moe_layer(ref, cfg, mesh):
    """The reference's MoE layer weights as this rank's blocks."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import set_param

    layer = L.MoE(cfg, "meta")
    shapes = L._moe_shapes(cfg)
    for n in L.MOE_NAMES:
        full = torch.from_numpy(ref[f"moe/layer/{n}"].copy())
        spec = shd.spec_for(mesh, shapes[n], L.MOE_NAMES[n], shd.rules_for_profile("tp_fsdp"))
        set_param(layer, n, shd.shard_of(full, spec, mesh).clone())
    return layer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh_train")
    _write_inputs(wd)
    ref = run_reference("import contextlib\n" + REF_LM + REFERENCE, wd)
    return ref, run_port(_port_ranks, wd, worlds=(4, 8)), wd


@pytest.fixture(scope="module")
def single(runs):
    """The port's one-device AdamW steps from the reference's weights."""
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import make_train_step

    ref, _, wd = runs
    cfg = get_config("qwen2-1.5b").reduced(**CFG_KW)
    state = train_state_from_numpy(_nest(ref, "dense/init"), _ref_opt(ref, "dense/init", "adamw"),
                                   cfg, device="cpu")
    step = make_train_step(cfg, OptConfig(kind="adamw", **OC_KW))
    losses, snaps = [], {}
    for i, b in enumerate(_batches(wd)):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if i in (0, 2):
            snaps[i + 1] = {f"params/{n}": p.detach().numpy().copy()
                            for n, p in state.params.named_parameters()}
            snaps[i + 1].update({f"m/{n}": t.numpy().copy() for n, t in state.opt.m.items()})
            snaps[i + 1].update({f"v/{n}": t.numpy().copy() for n, t in state.opt.v.items()})
    return np.asarray(losses), snaps


def _scale_name(name):
    return name[:-2] + "wk" if name.endswith("attn.bk") else name


def _lr_sum(k):
    from repro_torch.train.optimizer import OptConfig, lr_schedule

    return float(sum(lr_schedule(OptConfig(**OC_KW), s) for s in range(1, k + 1)))


def _check_dense(got, want, names, k, what, init):
    """``got(kind, name)`` against ``want(kind, name)`` after k steps; the
    parameters through their updates from ``init(name)``."""
    for n in names:
        du_got = got("params", n) - init(n)
        du_want = want("params", n) - init(n)
        if n.endswith("attn.bk"):
            # its gradient is rounding noise (softmax ignores a per-query
            # constant), so its update is about lr in a random sign
            np.testing.assert_array_less(np.abs(du_got), 1.01 * _lr_sum(k),
                                         err_msg=f"{what} update {n}")
        else:
            err = np.linalg.norm(du_got - du_want) / np.linalg.norm(du_want)
            assert err <= UPDATE_RTOL, f"{what} update {n}: relative error {err:.3g}"
        for kind in ("m", "v"):
            scale = np.abs(want(kind, _scale_name(n))).max() or 1.0
            np.testing.assert_allclose(got(kind, n), want(kind, n), rtol=0, atol=TOL * scale,
                                       err_msg=f"{what} {kind} {n}")


def _dense_names():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import param_shapes

    return list(param_shapes(get_config("qwen2-1.5b").reduced(**CFG_KW)))


@pytest.mark.parametrize("tag", ["2x2", "1x4", "4x2"])
def test_sharded_losses_match_reference_and_single_device(runs, single, tag):
    ref, port, _ = runs
    world = 8 if tag == "4x2" else 4
    got = port[world][f"dense/{tag}/loss"]
    np.testing.assert_allclose(got, ref[f"dense/{tag}/loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, single[0], rtol=LOSS_RTOL)
    # the reference's own sharded run equals its one-device run (Auto axes)
    np.testing.assert_allclose(ref[f"dense/{tag}/loss"], ref["dense/single/loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("tag", ["2x2", "1x4", "4x2"])
def test_sharded_state_matches_reference_sharded_step(runs, tag, k):
    ref, port, _ = runs
    out = port[8 if tag == "4x2" else 4]
    pre = f"dense/{tag}/s{k}"
    _check_dense(lambda kind, n: out[f"{pre}/{kind}/{n}"],
                 lambda kind, n: _ref_leaf(ref, f"{pre}/{kind}", n),
                 _dense_names(), k, f"{tag} step {k} vs reference",
                 lambda n: _ref_leaf(ref, "dense/init", n))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("tag", ["2x2", "1x4", "4x2"])
def test_sharded_state_matches_port_single_device(runs, single, tag, k):
    ref, port, _ = runs
    out = port[8 if tag == "4x2" else 4]
    pre = f"dense/{tag}/s{k}"
    _check_dense(lambda kind, n: out[f"{pre}/{kind}/{n}"],
                 lambda kind, n: single[1][k][f"{kind}/{n}"],
                 _dense_names(), k, f"{tag} step {k} vs one device",
                 lambda n: _ref_leaf(ref, "dense/init", n))


def _close_max(got, want, what):
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


@pytest.mark.parametrize("case", ["cf8", "cf1"])
def test_expert_sharded_moe_matches_reference(runs, case):
    """cf1: capacity factor 1, so bins overflow; C comes from each data
    rank's 32 tokens (C = 8), as in the reference's ``shard_map``, and the
    one-device layer (C from all 64) drops other assignments."""
    ref, port, _ = runs
    got = port[4][f"moe/{case}/2x2"]
    _close_max(got, ref[f"moe/{case}/2x2"], case)
    if case == "cf8":
        _close_max(got, ref["moe/cf8/single"], "cf8 vs one device")
    else:
        assert np.abs(got - ref["moe/cf1/single"]).max() > 1e-3, "no assignment was dropped"


def test_weight_stationary_decode_matches_reference(runs):
    ref, port, _ = runs
    got = port[8]["moe/ws/2x4"]
    _close_max(got, ref["moe/ws/2x4"], "weight-stationary vs reference")
    _close_max(got, ref["moe/ws/oracle"], "weight-stationary vs dense oracle")


@pytest.mark.parametrize("axis", ["data", "model"])
def test_moe_combine_sharded(runs, axis):
    _, port, _ = runs
    rng = np.random.default_rng(0)
    T_, k, d = 37, 2, 16
    tok = np.arange(T_).repeat(k)
    rows = rng.standard_normal((T_ * k, d)).astype(np.float32)
    gw = rng.random(T_ * k).astype(np.float32)
    want = np.zeros((T_, d), np.float32)
    np.add.at(want, tok, rows * gw[:, None])
    np.testing.assert_allclose(port[4][f"combine/{axis}"], want, rtol=1e-5, atol=1e-5)


def test_moe_adafactor_step_matches_reference(runs):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import param_shapes

    ref, port, _ = runs
    out = port[4]
    np.testing.assert_allclose(out["moelm/2x2/loss"], ref["moelm/2x2/loss"], rtol=LOSS_RTOL)
    for n in param_shapes(get_config("qwen3-moe-235b-a22b").reduced(**CFG_KW)):
        _close_max(out[f"moelm/2x2/params/{n}"], _ref_leaf(ref, "moelm/2x2/params", n), n)
    for key in sorted(k for k in out if k.startswith("moelm/2x2/v/")):
        leaf, i = key[len("moelm/2x2/v/"):].rsplit("/", 1)
        want = ref[f"moelm/2x2/v/{leaf.replace('.', '/')}" + (f"/{i}" if
                   f"moelm/2x2/v/{leaf.replace('.', '/')}/{i}" in ref else "")]
        _close_max(out[key], want, key)

