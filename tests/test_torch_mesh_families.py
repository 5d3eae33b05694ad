"""The ssm, hybrid, vlm and encdec families trained over a (data, model)
mesh of ranks: the port's sharded AdamW step against the reference's own
sharded step on the same mesh and against the port's one-device step.

The reference runs once, in a subprocess with 8 forced host devices, on
Auto-axis meshes (``torch_sharded_harness.REF_LM``); the port runs in a
gloo group of 4 spawned CPU ranks on 2x2 and 1x4, every rank gathering
its blocks and returning the whole state (all ranks must agree). Models:
``zamba2-2.7b``, ``xlstm-350m``, ``llama-3.2-vision-11b`` and
``whisper-base`` reduced (float32) from the reference's initial weights,
two steps of B 4 x S 32 (one row's first labels -1), the vlm's batches
with ``img_embed`` and Whisper's with ``enc_embed``, so the cross layers,
the image projection and the encoder train too. The losses are the
chained steps'; each step's state is held from the same state before it
(the second from the reference's state after the first on that mesh, as
``tests/test_torch_train_families.py`` holds its steps).

Tolerances, as ``test_torch_mesh_train.py`` where the gradients allow:
losses rtol 1e-5; AdamW's moments within ``TOL`` (1e-5) of their leaf's
max; each parameter's update from the weights before the step within
``UPDATE_RTOL`` (1e-3) of the wanted update in norm, over the elements
whose wanted first moment exceeds the moments' tolerance times its max:
there the tolerance fixes the update's sign and size, so a skipped update
reads 1 and a flipped one 2. The other elements, whose gradient is
rounding noise at that tolerance (the embedding's rows that no token of
the batch reaches, whose moments are 0; the key bias ``bk``, as in that
file), are held within two updates' size, 2 lr_k + 1e-6: AdamW's first
steps move an element by about lr whatever its gradient's size. The vlm
and encdec families hold this against the reference and the port's
one-device step.

xlstm's and zamba2's gradients carry their float32 conditioning
(``tests/test_torch_train_families.py``, ROADMAP Queue 3), so their
moments' tolerance (and with it the elements the update's norm covers) is
their measured reading with room, the worst over both meshes and both
steps: against the reference (``MOMENT_TOL``) xlstm at its stated 4e-4 of
max |g| (read 2.7e-4 in m, 1.8e-4 in v, at ``blocks.0.mlstm.in_proj``),
zamba2 at 1e-4 (read 8.2e-5 in m at a Mamba2 block's ``D``, 8.0e-5 in v;
that file reads 1.1e-5 to 4.5e-5 at its smaller batches and holds 6e-5);
against the port's one-device step (``ONE_DEVICE_MOMENT_TOL``), where
only the ranks' order of summation differs, xlstm at 8e-5 (read 2.5e-5 and
3.9e-5) and zamba2 at 4e-5 (read 1.4e-5 and 1.9e-5). The updates then read
at most 1.2e-4 (xlstm) and 7.1e-5 (zamba2) against the reference, 6.9e-5
and 2.0e-4 against one device, the elements left out at most 1.97 lr from
the reference's (sign flips) and 0.05 lr from one device's. xlstm's
chained second loss, which follows a step from differing gradients, is
held within rtol 1e-4 of the reference's.
"""
import os

import numpy as np
import pytest
import torch

from torch_sharded_harness import (REF_LM, gathered_state, nest, ref_leaf, ref_opt, run_port,
                                   run_reference, save_rank)

ARCHS = ("zamba2-2.7b", "xlstm-350m", "llama-3.2-vision-11b", "whisper-base")
MESHES = ("2x2", "1x4")
B, SEQ, STEPS = 4, 32, 2
OC_KW = dict(warmup_steps=2, total_steps=20)
LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-3
TOL = 1e-5
# the moments' tolerance where the gradients' conditioning needs more (docstring)
MOMENT_TOL = {"xlstm-350m": 4e-4, "zamba2-2.7b": 1e-4}  # against the reference
ONE_DEVICE_MOMENT_TOL = {"xlstm-350m": 8e-5, "zamba2-2.7b": 4e-5}
CHAIN_LOSS_RTOL = {"xlstm-350m": 1e-4}

REFERENCE = """
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.models import transformer as RT
from repro.models.params import unbox
from repro.train import optimizer as RO, steps as RS

oc = RO.OptConfig(kind="adamw", **OC_KW)
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    params, _ = unbox(RT.init_params(jax.random.PRNGKey(0), cfg))
    flat(f"{arch}/init", params)
    batches = [{k.rsplit("/", 1)[1]: jnp.asarray(v) for k, v in inputs.items()
                if k.startswith(f"{arch}/b{i}/")} for i in range(STEPS)]
    step = RS.make_train_step(cfg, oc)
    for tag in MESHES:
        with shd.use_mesh(mesh(tag)):
            s = RS.TrainState(params, RO.init_opt_state(params, oc))
            f = jax.jit(step)
            losses = []
            for i, b in enumerate(batches):
                s, m = f(s, b)
                losses.append(float(m["loss"]))
                flat(f"{arch}/{tag}/s{i + 1}/params", s.params)
                flat(f"{arch}/{tag}/s{i + 1}/m", s.opt.m)
                flat(f"{arch}/{tag}/s{i + 1}/v", s.opt.v)
        out[f"{arch}/{tag}/loss"] = np.asarray(losses)
"""


def _write_inputs(workdir):
    from repro_torch.configs import get_config

    rng = np.random.default_rng(27)
    d = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        for i in range(STEPS):
            d[f"{arch}/b{i}/tokens"] = rng.integers(0, 512, (B, SEQ)).astype(np.int32)
            labels = rng.integers(0, 512, (B, SEQ)).astype(np.int32)
            labels[1, :5 + i] = -1
            d[f"{arch}/b{i}/labels"] = labels
            if cfg.family == "vlm":
                d[f"{arch}/b{i}/img_embed"] = (rng.standard_normal(
                    (B, cfg.num_image_tokens, cfg.frontend_dim)) * 0.02).astype(np.float32)
            if cfg.family == "encdec":
                d[f"{arch}/b{i}/enc_embed"] = (rng.standard_normal(
                    (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    np.savez(os.path.join(str(workdir), "inputs.npz"), **d)


def _batches(workdir, arch):
    with np.load(os.path.join(str(workdir), "inputs.npz")) as z:
        return [{k.rsplit("/", 1)[1]: torch.from_numpy(z[k].copy()) for k in z.files
                 if k.startswith(f"{arch}/b{i}/")} for i in range(STEPS)]


def _ref_state(ref, pre, step):
    """(parameter tree, ``OptState``-like) of the reference's state saved
    under ``pre`` after ``step`` steps."""
    from types import SimpleNamespace

    return nest(ref, f"{pre}/params"), SimpleNamespace(step=step, m=nest(ref, f"{pre}/m"),
                                                       v=nest(ref, f"{pre}/v"))


def _port_ranks(rank, world, workdir):
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import make_train_step

    with np.load(os.path.join(str(workdir), "ref.npz")) as z:
        ref = {k: z[k] for k in z.files}
    oc = OptConfig(kind="adamw", **OC_KW)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        for tag in MESHES:
            D, M = (int(x) for x in tag.split("x"))
            mesh = shd.make_rank_mesh(D, M, device="cpu")
            state = train_state_from_numpy(nest(ref, f"{arch}/init"),
                                           ref_opt(ref, f"{arch}/init", "adamw"), cfg,
                                           device="cpu", mesh=mesh)
            step = make_train_step(cfg, oc, mesh=mesh)
            batches = _batches(workdir, arch)
            losses = []
            for i, b in enumerate(batches):
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                if i == 0:
                    out.update(gathered_state(state, cfg, mesh, f"{arch}/{tag}/s1"))
            out[f"{arch}/{tag}/loss"] = np.asarray(losses)
            for k in range(2, STEPS + 1):  # from the reference's state before the step
                state = train_state_from_numpy(*_ref_state(ref, f"{arch}/{tag}/s{k - 1}", k - 1),
                                               cfg, device="cpu", mesh=mesh)
                state, _ = step(state, batches[k - 1])
                out.update(gathered_state(state, cfg, mesh, f"{arch}/{tag}/s{k}"))
    save_rank(workdir, world, rank, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh_families")
    _write_inputs(wd)
    consts = (f"ARCHS = {ARCHS!r}\nMESHES = {MESHES!r}\nSTEPS = {STEPS}\n"
              f"OC_KW = {OC_KW!r}\n")
    ref = run_reference(consts + REF_LM + REFERENCE, wd)
    return ref, run_port(_port_ranks, wd, worlds=(4,))[4], wd


@pytest.fixture(scope="module")
def single(runs):
    """{arch: (chained losses, {(tag, k): {"<kind>/<name>": array}})}: the
    port's one-device AdamW steps from the reference's weights, step k > 1
    from the reference's state after step k - 1 on mesh ``tag``."""
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import make_train_step

    def snap(state):
        out = {f"params/{n}": p.detach().numpy().copy() for n, p in state.params.named_parameters()}
        out.update({f"m/{n}": t.numpy().copy() for n, t in state.opt.m.items()})
        out.update({f"v/{n}": t.numpy().copy() for n, t in state.opt.v.items()})
        return out

    ref, _, wd = runs
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        state = train_state_from_numpy(nest(ref, f"{arch}/init"),
                                       ref_opt(ref, f"{arch}/init", "adamw"), cfg, device="cpu")
        step = make_train_step(cfg, OptConfig(kind="adamw", **OC_KW))
        batches = _batches(wd, arch)
        losses, snaps = [], {}
        for i, b in enumerate(batches):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            if i == 0:
                snaps.update({(tag, 1): snap(state) for tag in MESHES})
        for tag in MESHES:
            for k in range(2, STEPS + 1):
                state = train_state_from_numpy(*_ref_state(ref, f"{arch}/{tag}/s{k - 1}", k - 1),
                                               cfg, device="cpu")
                state, _ = step(state, batches[k - 1])
                snaps[(tag, k)] = snap(state)
        out[arch] = (np.asarray(losses), snaps)
    return out


def _names(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import param_shapes

    return list(param_shapes(get_config(arch).reduced()))


def _check(got, want, before, what, arch, k, tol):
    """``got(kind, name)`` against ``want(kind, name)`` after step k from
    the parameters ``before(name)``: the moments within ``tol`` of their
    max, each parameter's update within ``UPDATE_RTOL`` in norm over the
    elements whose wanted first moment exceeds ``tol`` of its max, and
    within 2 lr_k + 1e-6 elsewhere (docstring)."""
    from repro_torch.train.optimizer import OptConfig, lr_schedule

    lr = float(lr_schedule(OptConfig(**OC_KW), k))
    for n in _names(arch):
        m = np.abs(want("m", n))
        held = m > tol * m.max()
        du_got = got("params", n) - before(n)
        du_want = want("params", n) - before(n)
        if held.any():
            err = np.linalg.norm((du_got - du_want)[held]) / np.linalg.norm(du_want[held])
            assert err <= UPDATE_RTOL, f"{what} update {n}: relative error {err:.3g}"
        np.testing.assert_allclose(du_got[~held], du_want[~held], rtol=0, atol=2 * lr + 1e-6,
                                   err_msg=f"{what} update {n} off the held elements")
        for kind in ("m", "v"):
            scale = np.abs(want(kind, n)).max() or 1.0
            np.testing.assert_allclose(got(kind, n), want(kind, n), rtol=0, atol=tol * scale,
                                       err_msg=f"{what} {kind} {n}")


def _before(ref, arch, tag, k):
    """The parameters step k started from: the initial weights, or the
    reference's after step k - 1 on ``tag``."""
    pre = f"{arch}/init" if k == 1 else f"{arch}/{tag}/s{k - 1}/params"
    return lambda n: ref_leaf(ref, pre, n)


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_losses_match_reference_and_single_device(runs, single, arch, tag):
    ref, port, _ = runs
    got = port[f"{arch}/{tag}/loss"]
    assert got.shape == (STEPS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got[:1], ref[f"{arch}/{tag}/loss"][:1], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, ref[f"{arch}/{tag}/loss"],
                               rtol=CHAIN_LOSS_RTOL.get(arch, LOSS_RTOL))
    np.testing.assert_allclose(got, single[arch][0], rtol=LOSS_RTOL)


@pytest.mark.parametrize("k", range(1, STEPS + 1))
@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_state_matches_reference_sharded_step(runs, arch, tag, k):
    ref, port, _ = runs
    pre = f"{arch}/{tag}/s{k}"
    _check(lambda kind, n: port[f"{pre}/{kind}/{n}"],
           lambda kind, n: ref_leaf(ref, f"{pre}/{kind}", n), _before(ref, arch, tag, k),
           f"{pre} vs reference", arch, k, MOMENT_TOL.get(arch, TOL))


@pytest.mark.parametrize("k", range(1, STEPS + 1))
@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_state_matches_port_single_device(runs, single, arch, tag, k):
    ref, port, _ = runs
    pre = f"{arch}/{tag}/s{k}"
    _check(lambda kind, n: port[f"{pre}/{kind}/{n}"],
           lambda kind, n: single[arch][1][(tag, k)][f"{kind}/{n}"], _before(ref, arch, tag, k),
           f"{pre} vs one device", arch, k, ONE_DEVICE_MOMENT_TOL.get(arch, TOL))


@pytest.mark.parametrize("fault", ["skipped", "flipped"])
@pytest.mark.parametrize("arch", ARCHS)
def test_check_rejects_a_faulty_update(runs, arch, fault):
    """``_check``'s rule, at each family's looser tolerance, rejects the
    port's first 2x2 step with one update skipped or flipped in sign: the
    Mamba2 or mLSTM input projection, or a dense layer's ``mlp.w1``."""
    ref, port, _ = runs
    pre = f"{arch}/2x2/s1"
    before = _before(ref, arch, "2x2", 1)
    name = next(n for n in _names(arch) if n.endswith(("in_proj", "w_in", "mlp.w1")))

    def got(kind, n):
        if kind == "params" and n == name:
            return before(n) if fault == "skipped" else 2 * before(n) - port[f"{pre}/params/{n}"]
        return port[f"{pre}/{kind}/{n}"]

    with pytest.raises(AssertionError, match=f"update {name}"):
        _check(got, lambda kind, n: ref_leaf(ref, f"{pre}/{kind}", n), before, pre, arch, 1,
               MOMENT_TOL.get(arch, TOL))
