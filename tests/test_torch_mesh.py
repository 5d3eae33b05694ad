"""The mesh layer of the port (``repro_torch.distributed``) against the
reference's ``repro.distributed``: specs, block shapes, the parameters'
logical names, int8 error-feedback compression, GPipe, and a checkpoint
restored onto another mesh shape.

Specs, shapes and names need no devices: the reference's ``spec_for``
and ``NamedSharding.shard_shape`` take a ``jax.sharding.AbstractMesh``,
and its parameter tree is built under ``abstract_init``. Compression and
GPipe run the reference once in a subprocess with 8 forced host devices
(Auto-axis meshes) and the port in gloo groups of 4, 8 and 2 spawned CPU
ranks (``torch_sharded_harness``), every rank returning the whole result;
the 2-rank group restores the 4-rank group's checkpoint. Tolerances:
specs, shapes and names equal; compression's outputs and residuals within
1e-6 of the reference's (the int32 code sums are exact; the scales' sum
runs in another order), its error within the reference test's 0.05, and
the two-step error no larger; GPipe within 1e-6 of the reference and of
the stages run in order; the restored blocks equal bit for bit.
"""
import itertools
import os

import numpy as np
import pytest
import torch

from torch_sharded_harness import run_port, run_reference, save_rank

MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "4x2": {"data": 4, "model": 2}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}
ARCHS = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "qwen2.5-14b", "deepseek-7b", "phi3-medium-14b",
         "llama4-maverick-400b-a17b", "xlstm-350m", "zamba2-2.7b", "llama-3.2-vision-11b",
         "whisper-base")
SERVE_ARCHS = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "xlstm-350m", "zamba2-2.7b",
               "llama-3.2-vision-11b", "whisper-base")  # one of each family
NAMES = (None, "batch", "seq", "seq_kv", "embed", "embed_act", "heads", "kv_heads", "qkv",
         "mlp", "vocab", "experts", "expert_mlp", "layers")
SIZES = (1, 2, 3, 4, 6, 8, 12, 16)
PIPE = dict(stages=4, M=8, mb=2, d=16)
COMP = (64, 64)


def _abstract(shape: dict):
    from jax.sharding import AbstractMesh

    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _port_mesh(shape: dict, rank: int = 0):
    from repro_torch.distributed.sharding import Mesh

    return Mesh(shape, rank=rank)


def _as_tuple(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec)


@pytest.mark.parametrize("profile", ["tp_fsdp", "ddp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_matches_reference(mesh, profile):
    from repro.distributed import sharding as RS
    from repro_torch.distributed import sharding as S

    amesh, pmesh = _abstract(MESHES[mesh]), _port_mesh(MESHES[mesh])
    rrules, prules = RS.rules_for_profile(profile), S.rules_for_profile(profile)
    assert prules == rrules and S.DEFAULT_RULES == RS.DEFAULT_RULES
    rng = np.random.default_rng(0)
    for ndim in (1, 2, 3):
        for names in itertools.product(NAMES, repeat=ndim):
            shape = tuple(int(x) for x in rng.choice(SIZES, ndim))
            want = RS.spec_for(amesh, shape, names, rrules)
            got = S.spec_for(pmesh, shape, names, prules)
            assert _as_tuple(got) == _as_tuple(tuple(want)), (shape, names)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_match_shard_shape(arch, mesh):
    """Every rank's block of every leaf has ``NamedSharding.shard_shape``,
    and ``shard_of`` of a whole leaf on every rank tiles it exactly."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.models.transformer import param_shapes, param_specs

    cfg = get_config(arch)
    shape = MESHES[mesh]
    amesh = _abstract(shape)
    rules = S.rules_for_profile(cfg.sharding_profile)
    specs = param_specs(cfg, _port_mesh(shape), rules)
    for name, full in param_shapes(cfg).items():
        want = NamedSharding(amesh, P(*specs[name])).shard_shape(full)
        n = int(np.prod(list(shape.values())))
        for r in (0, n - 1):
            assert S.shard_shape(full, specs[name], _port_mesh(shape, r)) == tuple(want), name
    # blocks of a small leaf tile it: every element once per replica
    cfg = cfg.reduced()
    for name, full in param_shapes(cfg).items():
        spec = param_specs(cfg, _port_mesh(shape), rules)[name]
        t = torch.arange(int(np.prod(full)), dtype=torch.float32).reshape(full)
        seen = torch.zeros_like(t)
        n = int(np.prod(list(shape.values())))
        for r in range(n):
            blk = S.shard_of(t, spec, _port_mesh(shape, r))
            S.shard_of(seen, spec, _port_mesh(shape, r)).add_(1)
            assert blk.shape == S.shard_shape(full, spec, _port_mesh(shape, r))
        reps = n // _port_mesh(shape).axis_size(S.spec_axes(spec))
        assert torch.equal(seen, torch.full_like(t, reps)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_names_match_boxed_axes(arch):
    from repro.configs import get_config as ref_get_config
    from repro.models import params as RP
    from repro.models import transformer as RT
    import jax

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import param_axes
    from repro_torch.train.optimizer import reference_leaf

    for reduced in (False, True):
        rcfg, cfg = ref_get_config(arch), get_config(arch)
        if reduced:
            rcfg, cfg = rcfg.reduced(), cfg.reduced()
        with RP.abstract_init():
            _, axes = RP.unbox(RT.init_params(jax.random.PRNGKey(0), rcfg))
        for name, names in param_axes(cfg).items():
            key, index = reference_leaf(name)
            node = axes
            for k in key.split("."):
                node = node[k]
            want = tuple(node)
            if index is not None:
                assert want[:len(index)] == ("layers",) * len(index), (name, want)
                want = want[len(index):]
            assert tuple(names) == want, name


def test_families_off_the_mesh_raise():
    """No family is off the mesh any more: the ssm, hybrid, vlm and encdec
    families' parameters carry the reference's ``Boxed`` axes, including
    the leaves only they have (Mamba2's, the LSTMs', ``xattn``,
    ``shared_attn``, ``img_proj``, ``enc_pos``)."""
    from repro.configs import get_config as ref_get_config
    from repro.models import params as RP
    from repro.models import transformer as RT
    import jax

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import MESH_FAMILIES, PORTED_FAMILIES, param_axes
    from repro_torch.train.optimizer import reference_leaf

    assert MESH_FAMILIES == PORTED_FAMILIES
    seen = set()
    for arch in ("xlstm-350m", "zamba2-2.7b", "llama-3.2-vision-11b", "whisper-base"):
        with RP.abstract_init():
            _, axes = RP.unbox(RT.init_params(jax.random.PRNGKey(0), ref_get_config(arch)))
        for name, names in param_axes(get_config(arch)).items():
            key, index = reference_leaf(name)
            node = axes
            for k in key.split("."):
                node = node[k]
            assert tuple(names) == tuple(node)[len(index or ()):], name
            seen.update(key.split("."))
    assert {"mamba", "mlstm", "slstm", "xattn", "shared_attn", "img_proj", "enc_pos"} <= seen


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_cache_blocks_match_shard_shape(arch, mesh):
    """Every cache leaf's spec is the reference's ``spec_for`` of its
    ``init_cache`` axes (under ``abstract_init``), and every rank's block
    has ``NamedSharding.shard_shape``: an engine's 4 slots of 64
    positions, and its one-row prefill (its row whole on every rank, the
    other dims as the slots' layout)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.distributed import sharding as RS
    from repro.models import params as RP
    from repro.models import transformer as RT
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.models import transformer as T

    shape = MESHES[mesh]
    amesh = _abstract(shape)
    rules = S.rules_for_profile("tp_fsdp")
    n = int(np.prod(list(shape.values())))
    cfg = get_config(arch).reduced()
    with RP.abstract_init():
        boxed = RT.init_cache(ref_get_config(arch).reduced(), 4, 64).caches
    want = [RS.spec_for(amesh, b.value.shape, b.axes, rules)
            for b in jax.tree.leaves(boxed, is_leaf=RP.is_boxed)]
    shapes = [tuple(b.value.shape) for b in jax.tree.leaves(boxed, is_leaf=RP.is_boxed)]
    def leaves(tree):  # in jax's order: a dict's keys sorted
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [x for v in tree for x in leaves(v)] if isinstance(tree, tuple) else [tree]

    specs = leaves(T.cache_specs(cfg, 4, 64, _port_mesh(shape), rules=rules))
    assert [_as_tuple(sp.entries) for sp in specs] == [_as_tuple(tuple(w)) for w in want]
    for r in (0, n - 1):
        pm = _port_mesh(shape, r)
        st = T.init_cache(cfg, 4, 64, device="cpu", mesh=pm, rules=rules)
        for t, sp, full in zip(leaves(st.caches), leaves(st.specs), shapes):
            assert tuple(t.shape) == NamedSharding(amesh, P(*sp.entries)).shard_shape(full)
        one = T.init_cache(cfg, 1, 64, device="cpu", mesh=pm, layout_batch=4, rules=rules)
        for t, sp, big in zip(leaves(one.caches), leaves(one.specs), specs):
            assert sp.entries[sp.batch] is None or sp.entries == big.entries
            assert sp.entries[:sp.batch] + sp.entries[sp.batch + 1:] == \
                big.entries[:big.batch] + big.entries[big.batch + 1:]
            assert t.shape[sp.batch] == 1


@pytest.mark.parametrize("M,P", [(8, 4), (1, 1), (4, 2), (32, 16)])
def test_bubble_fraction(M, P):
    from repro.distributed.pipeline import bubble_fraction as ref
    from repro_torch.distributed.pipeline import bubble_fraction

    assert bubble_fraction(M, P) == ref(M, P)


def test_mesh_layout_is_row_major():
    from repro_torch.distributed.sharding import Mesh

    m = Mesh({"pod": 2, "data": 2, "model": 2}, rank=5)  # 5 = (1, 0, 1)
    assert m.coords == {"pod": 1, "data": 0, "model": 1}
    assert m.axis_index(("pod", "data")) == 2 and m.axis_index("model") == 1
    assert m.axis_index(("data", "pod")) == 2  # mesh order, as a spec's tuple entry


REFERENCE = """
from jax.sharding import AxisType
from repro.distributed.compression import compressed_psum_tree, init_residuals
from repro.distributed.pipeline import gpipe_apply

def mesh(shape, axes):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:int(np.prod(shape))])

m8 = mesh((8, 1), ("data", "model"))
g = {"w": jnp.asarray(inputs["g"])}
r = init_residuals(g)
o1, r1 = compressed_psum_tree(g, r, m8, axes=("data",))
o2, r2 = compressed_psum_tree(g, r1, m8, axes=("data",))
out.update(c_o1=np.asarray(o1["w"]), c_r1=np.asarray(r1["w"]), c_o2=np.asarray(o2["w"]),
           c_r2=np.asarray(r2["w"]))
pm = mesh((4,), ("pipe",))
y = gpipe_apply(lambda p, x: jnp.tanh(x @ p["w"]), {"w": jnp.asarray(inputs["pw"])},
                jnp.asarray(inputs["px"]), pm)
out["pipe"] = np.asarray(y)
"""


def _write_inputs(workdir):
    rng = np.random.default_rng(12)
    d = {"g": rng.standard_normal(COMP).astype(np.float32),
         "pw": (rng.standard_normal((PIPE["stages"], PIPE["d"], PIPE["d"])) * 0.3
                ).astype(np.float32),
         "px": rng.standard_normal((PIPE["M"], PIPE["mb"], PIPE["d"])).astype(np.float32)}
    np.savez(os.path.join(str(workdir), "inputs.npz"), **d)


def _rank_grad(g, data_index):
    """Rank ``data_index``'s gradient in the different-gradients case."""
    rng = np.random.default_rng(100 + data_index)
    return g * (1 + 0.01 * rng.standard_normal(g.shape)).astype(np.float32)


def _remesh_state(cfg, mesh, oc):
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.steps import TrainState

    model = T.init_params(cfg, seed=0, device="cpu", mesh=mesh)
    return TrainState(model, init_opt_state(dict(model.named_parameters()), oc))


def _remesh_batches():
    rng = np.random.default_rng(5)
    return [{k: torch.from_numpy(rng.integers(0, 512, (4, 32)).astype(np.int32))
             for k in ("tokens", "labels")} for _ in range(2)]


def _whole_state(state, cfg, mesh):
    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.steps import state_specs

    specs, _ = state_specs(state, cfg, mesh)
    return {f"state/{p}": (shd.gather(v.detach(), specs[p], mesh) if p in specs
                           else v.detach()).numpy().copy()
            for p, v in _flatten_with_paths(state) if isinstance(v, torch.Tensor)}


def _port_ranks(rank, world, workdir):
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.compression import compressed_psum_tree, init_residuals
    from repro_torch.distributed.pipeline import gpipe_apply
    from repro_torch.ft.resilience import ElasticPlan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import make_train_step, state_specs

    with np.load(os.path.join(str(workdir), "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    out = {}
    cfg = get_config("qwen2-1.5b").reduced()
    oc = OptConfig(kind="adamw", warmup_steps=2, total_steps=20)
    ckdir = os.path.join(str(workdir), "ckpt")
    batches = _remesh_batches()
    if world == 8:
        mesh = shd.make_rank_mesh(8, 1, device="cpu")
        g = {"w": torch.from_numpy(inputs["g"])}
        o1, r1 = compressed_psum_tree(g, init_residuals(g), mesh, axes=("data",))
        o2, r2 = compressed_psum_tree(g, r1, mesh, axes=("data",))
        out.update(c_o1=o1["w"].numpy(), c_r1=r1["w"].numpy(), c_o2=o2["w"].numpy(),
                   c_r2=r2["w"].numpy())
    if world == 4:
        mesh = shd.make_rank_mesh(2, 2, device="cpu")
        # compression with a different gradient on each data rank
        gd = {"w": torch.from_numpy(_rank_grad(inputs["g"], mesh.axis_index("data")))}
        od, rd = compressed_psum_tree(gd, init_residuals(gd), mesh, axes=("data",))
        out["cd_o"] = od["w"].numpy()
        out["cd_r"] = shd.all_gather(rd["w"][None], 0, "data", mesh).numpy()
        # GPipe: stage s is the rank at pipe coordinate s
        pmesh = shd.make_mesh({"pipe": 4}, device="cpu")
        w = torch.from_numpy(inputs["pw"][pmesh.axis_index("pipe")])
        out["pipe"] = gpipe_apply(lambda p, x: torch.tanh(x @ p), w,
                                  torch.from_numpy(inputs["px"]), pmesh).numpy()
        # a checkpoint of a 2x2 state after one step, then its second step
        state = _remesh_state(cfg, mesh, oc)
        step = make_train_step(cfg, oc, mesh=mesh)
        state, _ = step(state, batches[0])
        specs, shapes = state_specs(state, cfg, mesh)
        CheckpointManager(ckdir).save(1, state, blocking=True, mesh=mesh, specs=specs,
                                      shapes=shapes)
        out.update(_whole_state(state, cfg, mesh))
        state, m = step(state, batches[1])
        out["loss2"] = np.asarray(float(m["loss"]))
        # restored onto the other 4-rank shapes, bit for bit
        for D, M in ((4, 1), (1, 4)):
            other = shd.make_rank_mesh(D, M, device="cpu")
            target = _remesh_state(cfg, other, oc)
            restored, at = CheckpointManager(ckdir).restore(
                target, mesh=other, specs=state_specs(target, cfg, other)[0])
            assert at == 1
            out.update({f"{D}x{M}/{k}": v for k, v in _whole_state(restored, cfg, other).items()})
    if world == 2:
        plan = ElasticPlan(old_data=2, old_model=2, surviving_devices=2)
        D, M = plan.mesh_shape()
        mesh = shd.make_rank_mesh(D, M, device="cpu")
        target = _remesh_state(cfg, mesh, oc)
        restored, at = CheckpointManager(ckdir).restore(
            target, mesh=mesh, specs=state_specs(target, cfg, mesh)[0])
        out.update({f"{D}x{M}/{k}": v for k, v in _whole_state(restored, cfg, mesh).items()})
        # and on one device: the whole leaves, assembled from the blocks
        whole, _ = CheckpointManager(ckdir).restore(_remesh_state(cfg, None, oc))
        out.update({f"1/state/{p}": v.detach().numpy().copy()
                    for p, v in _flatten_with_paths(whole) if isinstance(v, torch.Tensor)})
        step = make_train_step(cfg, oc, accum_steps=plan.accumulation_steps(1), mesh=mesh)
        _, m = step(restored, batches[1])
        out["loss2"] = np.asarray(float(m["loss"]))
    save_rank(workdir, world, rank, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh")
    _write_inputs(wd)
    ref = run_reference(REFERENCE, wd)
    return ref, run_port(_port_ranks, wd, worlds=(8, 4, 2)), wd


def test_compression_identical_grads_matches_reference(runs):
    ref, port, wd = runs
    out = port[8]
    for k in ("c_o1", "c_r1", "c_o2", "c_r2"):
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
    with np.load(os.path.join(str(wd), "inputs.npz")) as z:
        g = z["g"]
    err1 = np.abs(out["c_o1"] - g).max()
    err2 = np.abs((out["c_o1"] + out["c_o2"]) / 2 - g).max()
    assert err1 < 0.05 and err2 < err1 + 1e-6, (err1, err2)


def test_compression_different_grads_gives_the_mean(runs):
    """Each data rank quantises its own gradient: the result is the
    reference's formula on their codes (emulated in numpy) and within the
    reference test's 0.05 of the mean; the residuals are each rank's loss."""
    _, port, wd = runs
    with np.load(os.path.join(str(wd), "inputs.npz")) as z:
        g = z["g"]
    gs = [_rank_grad(g, i) for i in range(2)]
    qs, scales = [], []
    for x in gs:
        s = np.float32(np.abs(x).max() / np.float32(127.0) + np.float32(1e-12))
        qs.append(np.clip(np.round(x / s), -127, 127).astype(np.int8))
        scales.append(s)
    mean_scale = np.float32(np.float32(scales[0] + scales[1]) / np.float32(2))
    want = (sum(q.astype(np.int32) for q in qs).astype(np.float32) * mean_scale) / np.float32(2)
    np.testing.assert_allclose(port[4]["cd_o"], want, rtol=0, atol=1e-6)
    assert np.abs(port[4]["cd_o"] - (gs[0] + gs[1]) / 2).max() < 0.05
    for i in range(2):
        np.testing.assert_allclose(port[4]["cd_r"][i], gs[i] - qs[i] * scales[i], rtol=0, atol=1e-6)


def test_gpipe_matches_reference_and_sequential(runs):
    ref, port, wd = runs
    with np.load(os.path.join(str(wd), "inputs.npz")) as z:
        x, w = torch.from_numpy(z["px"]), torch.from_numpy(z["pw"])
    y = x
    for s in range(PIPE["stages"]):
        y = torch.tanh(y @ w[s])
    np.testing.assert_allclose(port[4]["pipe"], ref["pipe"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(port[4]["pipe"], y.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("onto", ["4x1", "1x4", "1x2", "1"])
def test_checkpoint_restores_onto_another_mesh_bit_for_bit(runs, onto):
    """A 2x2 state saved after one step (in blocks, each rank its own file)
    comes back onto 4x1, 1x4, ``ElasticPlan(2, 2, 2)``'s 1x2 and one device
    with every leaf equal bit for bit."""
    _, port, _ = runs
    saved = {k: v for k, v in port[4].items() if k.startswith("state/")}
    got = port[2 if onto in ("1x2", "1") else 4]
    assert saved
    for k, v in saved.items():
        np.testing.assert_array_equal(got[f"{onto}/{k}"], v, err_msg=k)


def test_remeshed_step_loss(runs):
    """Elastic re-mesh: the next step on 1x2 with accumulation 2 gives the
    2x2 mesh's next loss (float32 rounding)."""
    _, port, _ = runs
    np.testing.assert_allclose(port[2]["loss2"], port[4]["loss2"], rtol=1e-5)
