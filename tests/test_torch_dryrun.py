"""The port's dry run (``repro_torch.launch.dryrun``), its report and the
registry/steps helpers it stands on, against the reference where the
reference has the same function.

* ``cells()`` equals the reference's (40 cells, the 8 ``long_500k``
  skips with their reasons); ``batch_struct`` has the reference's names,
  shapes and dtypes for every cell; ``serve_state_struct`` the
  reference's cache leaves; ``last_logits`` the reference's values on the
  reference's weights (float32, 1e-5 of max |logit|).
* State bytes per rank of the reduced qwen2 and qwen3-moe on a 2x4 mesh,
  parameters and both optimizers' state, equal the reference's
  ``device_bytes`` of its abstract state on an Auto-axis mesh (the
  reference runs in a subprocess with 8 forced host devices).
* The FLOPs counted for a reduced dense train step on one rank equal a
  count by hand of its matmuls, the kernels' own FLOPs and the plain
  attention backward, with remat off and on.
* In a subprocess (the ``fake`` process group is per process): reduced
  cells of every shape kind on a 2x2 fake world, the probe check exact,
  the accumulation search, and a failing cell recorded with its error.
* ``report.render`` rows equal the reference's on the same records, the
  fit column renamed.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import SHAPES as REF_SHAPES
from repro.configs.registry import cells as ref_cells
from repro.configs.registry import get_config as ref_get_config
from repro.launch import report as ref_report
from repro.models import transformer as RT
from repro.models.params import unbox
from repro.train import steps as ref_steps
from repro_torch.configs.registry import SHAPES, ShapeSpec, cells, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flashattn import flash_flops
from repro_torch.launch import dryrun, report
from repro_torch.models import transformer as T
from repro_torch.train import steps
from repro_torch.train.optimizer import OptConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_py(body: str, env_extra=None, timeout: int = 600) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **(env_extra or {}))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-3000:]}"
    return r.stdout.strip().splitlines()[-1]


# ---------------------------------------------------------------------------
# Registry and step helpers.
# ---------------------------------------------------------------------------


def test_cells_equal_the_reference():
    got, want = cells(include_skipped=True), ref_cells(include_skipped=True)
    assert got == want and len(got) == 40
    assert cells() == ref_cells() and len(cells()) == 32
    skips = [c for c in got if c[2]]
    assert len(skips) == 8 and all(s == "long_500k" for _, s, _ in skips)


@pytest.mark.parametrize("arch", sorted({a for a, _, _ in cells(include_skipped=True)}))
def test_batch_struct_matches_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name in SHAPES:
        got = steps.batch_struct(cfg, SHAPES[name])
        want = ref_steps.batch_struct(ref_cfg, REF_SHAPES[name])
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).replace("torch.", "") == str(want[k].dtype)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b", "llama-3.2-vision-11b"])
def test_serve_state_struct_matches_the_reference(arch):
    shape = ShapeSpec("d", 48, 3, "decode")
    got = T.cache_leaves(steps.serve_state_struct(get_config(arch).reduced(), shape).caches)
    want = jax.tree.leaves(ref_steps.serve_state_struct(ref_get_config(arch).reduced(), shape)
                           .caches)
    # jax orders a dict's leaves by key, the port by the tree's own order
    assert sorted((tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in got) == sorted(
        (tuple(w.shape), str(w.dtype)) for w in want)
    assert all(t.device.type == "meta" for t in got)


def test_last_logits_matches_the_reference():
    ref_cfg = ref_get_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    params = jax.jit(lambda key: unbox(RT.init_params(key, ref_cfg))[0])(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    hidden = np.random.default_rng(0).normal(size=(3, 7, cfg.d_model)).astype(np.float32)
    got = T.last_logits(model, torch.from_numpy(hidden), cfg)
    want = np.asarray(RT.last_logits(params, jax.numpy.asarray(hidden), ref_cfg))
    assert got.shape == (3, cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# State bytes per rank against the reference's abstract state.
# ---------------------------------------------------------------------------

REF_BYTES = """
import json, jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.launch.dryrun import abstract_opt_state, abstract_params, device_bytes
from repro.train.optimizer import OptConfig

mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in ("qwen2-1.5b", "qwen3-moe-235b-a22b"):
    cfg = get_config(arch).reduced()
    with shd.use_mesh(mesh, rules=shd.rules_for_profile(cfg.sharding_profile)):
        p, axes = abstract_params(cfg, mesh)
        row = {"params": device_bytes(p)}
        for kind in ("adamw", "adafactor"):
            o = abstract_opt_state(p, axes, OptConfig(kind=kind), mesh)
            row[kind] = device_bytes(o.v) + (device_bytes(o.m) if o.m is not None else 0)
    out[arch] = row
print(json.dumps(out))
"""


def test_state_bytes_per_rank_equal_the_reference():
    want = json.loads(run_py(REF_BYTES, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"}))
    mesh = shd.Mesh({"data": 2, "model": 4}, rank=0)
    for arch, row in want.items():
        cfg = get_config(arch).reduced()
        rules = shd.rules_for_profile(cfg.sharding_profile)
        assert dryrun.param_bytes(cfg, mesh, rules) == row["params"], arch
        for kind in ("adamw", "adafactor"):
            assert dryrun.opt_bytes(cfg, mesh, rules, OptConfig(kind=kind)) == row[kind], (arch,
                                                                                         kind)


# ---------------------------------------------------------------------------
# FLOPs by hand.
# ---------------------------------------------------------------------------


def hand_count(cfg, B, S):
    """FLOPs of one train step of a dense model on one rank: each layer's
    projections and MLP forward (2 FLOPs a multiply-add) and backward
    (twice: inputs and weights), the flash kernel's forward, the plain
    attention backward by query blocks (the recomputed scores and values
    and their two gradients: three times their forward, keys up to the
    block's last query), the rows kernel's embedding backward (one add an
    element), the logits (forward, the checkpoint's recompute and the two
    gradients); remat adds one forward of every layer up to its last
    matmul (the MLP's down projection: torch's non-reentrant checkpoint
    stops recomputing once every saved tensor is back, and nothing saves
    that product's output)."""
    T_, d, H, KH, hd, f, V = (B * S, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim, cfg.d_ff, cfg.padded_vocab)
    layer = 2 * T_ * d * (H * hd + 2 * KH * hd) + 2 * T_ * H * hd * d + 3 * 2 * T_ * d * f
    flash = flash_flops(B, H, S, S, hd, causal=True)
    qb = cfg.attn_q_block
    attn_bwd = sum(3 * 4 * B * H * (min(s + qb, S) - s) * min(s + qb, S) * hd
                   for s in range(0, S, qb))
    per_layer = 3 * layer + flash + attn_bwd + ((layer - 2 * T_ * f * d + flash)
                                                 if cfg.remat else 0)
    return cfg.num_layers * per_layer + T_ * d + 4 * 2 * T_ * d * V


@pytest.mark.parametrize("remat", [False, True])
def test_counted_flops_equal_a_hand_count(remat):
    cfg = get_config("qwen2-1.5b").reduced(remat=remat)
    B, S = 2, 64
    assert S > cfg.attn_q_block and S <= cfg.loss_chunk
    tr = dryrun.trace_cell(cfg, ShapeSpec("t", S, B, "train"))
    assert tr.flops == hand_count(cfg, B, S)
    assert tr.kernels["flash_attention"]["calls"] == cfg.num_layers * (2 if remat else 1)
    assert tr.kernels["cobra_bin_accumulate_rows"]["calls"] == 1
    assert tr.collective["total"] == 0
    # the state (parameters, two float32 moments, the batch) is live from the start
    state = sum(p.numel() * p.element_size() for p in T.LM(cfg, "meta").parameters())
    assert tr.peak_bytes > state * (1 + 2 * 4 // next(T.LM(cfg, "meta").parameters())
                                    .element_size())


def test_probe_extrapolation_is_exact_on_one_rank():
    cfg = get_config("qwen2-1.5b").reduced(num_layers=6)
    shape = ShapeSpec("t", 64, 2, "train")
    La, Lb = dryrun.probe_layers(cfg)
    from repro_torch.roofline import extrapolate

    full = extrapolate(dryrun.probe_cost(cfg, shape, None, La),
                       dryrun.probe_cost(cfg, shape, None, Lb), cfg.num_layers)
    assert full.flops == dryrun.trace_cell(cfg, shape).flops


# ---------------------------------------------------------------------------
# Cells on a fake world (a subprocess: the process group is per process).
# ---------------------------------------------------------------------------

FAKE_CELLS = """
import dataclasses, json
from repro_torch.configs.registry import SHAPES, ShapeSpec, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as D

D.SHAPES = dict(SHAPES, t=ShapeSpec("t", 64, 8, "train"), p=ShapeSpec("p", 64, 4, "prefill"),
                d=ShapeSpec("d", 64, 4, "decode"))


def reduced(arch):  # the reduced config as overrides of the full one
    full, red = get_config(arch), get_config(arch).reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


out = []
with D.fake_world(4):
    mesh = shd.make_mesh({"data": 2, "model": 2}, device="meta")
    for arch, kinds in (("qwen2-1.5b", "tpd"), ("qwen3-moe-235b-a22b", "t"), ("zamba2-2.7b", "p")):
        for s in kinds:
            out.append(D.analyze_cell(arch, s, "2x2", mesh, overrides=reduced(arch)))
    # the accumulation search: a card of 1.2x the state fits only at a higher factor
    ov = reduced("qwen2-1.5b")
    one = D.analyze_cell("qwen2-1.5b", "t", "2x2", mesh, overrides=ov, skip_probes=True)
    D.HBM_BYTES = 1.2 * one["memory_per_device"]["state_bytes"] / D.FIT_SHARE
    out.append(D.analyze_cell("qwen2-1.5b", "t", "2x2", mesh, overrides=ov, skip_probes=True))
    out.append(one)
# a cell that fails is recorded, and the run goes on
D.HBM_BYTES = 80e9
D.MESHES = {"2x2": {"data": 2, "model": 2}}
bad = D.run_cells([("qwen2-1.5b", "t"), ("no-such-arch", "t")], ["2x2"], skip_probes=True)
out.append([{k: r.get(k) for k in ("arch", "ok", "error")} for r in bad])
print(json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def fake_cells():
    return json.loads(run_py(FAKE_CELLS))


def test_reduced_cells_trace_on_a_fake_world(fake_cells):
    recs = fake_cells[:5]
    assert all(r["ok"] for r in recs), [r.get("error") for r in recs]
    for r in recs:
        pc = r["probe_costs"]
        assert pc["flops_extrapolated"] == pytest.approx(pc["flops_full_depth"], rel=1e-12)
        rl = r["roofline"]
        assert rl["chips"] == 4 and rl["hlo_flops"] == pytest.approx(4 * pc["flops_full_depth"])
        assert r["memory_per_device"]["live_bytes"] >= r["state_bytes_per_device"] > 0
    moe_train = recs[3]
    assert {"scatter_rows", "cobra_bin_accumulate_rows", "flash_attention"} <= set(
        moe_train["kernels"])
    assert all(r["roofline"]["collective_detail"]["total"] > 0 for r in recs)


def test_accumulation_search_climbs_until_it_fits(fake_cells):
    squeezed, one = fake_cells[5], fake_cells[6]
    assert one["accum_steps"] == 1 and squeezed["accum_steps"] > 1
    assert squeezed["memory_per_device"]["live_bytes"] < one["memory_per_device"]["live_bytes"]
    assert squeezed["roofline"]["hlo_flops"] == pytest.approx(one["roofline"]["hlo_flops"],
                                                              rel=1e-12)


def test_a_failing_cell_is_recorded(fake_cells):
    good, bad = fake_cells[7]
    assert good["ok"] and not bad["ok"] and "KeyError" in bad["error"]


# ---------------------------------------------------------------------------
# The report.
# ---------------------------------------------------------------------------


def _records():
    rl = {"t_compute_s": 0.0123, "t_memory_s": 0.0456, "t_collective_s": 0.0007,
          "bottleneck": "memory", "useful_ratio": 0.51, "roofline_fraction": 0.123}
    mem = {"live_bytes": 13.4e9, "live_bytes_tpu_corrected": 13.4e9}
    return [
        {"arch": "a", "shape": "train_4k", "mesh": "16x16", "ok": True, "accum_steps": 2,
         "roofline": rl, "memory_per_device": dict(mem, fits_16GB_hbm=True, fits_80GB_hbm=True)},
        {"arch": "b", "shape": "decode_32k", "mesh": "2x16x16", "ok": True, "accum_steps": 1,
         "memory_per_device": dict(mem, fits_16GB_hbm=False, fits_80GB_hbm=False)},
        {"arch": "c", "shape": "prefill_32k", "mesh": "16x16", "ok": False,
         "error": "RuntimeError: " + "x" * 100},
    ]


def test_report_rows_equal_the_reference():
    recs = _records()
    got = report.render(recs).splitlines()
    want = ref_report.render(recs).splitlines()
    assert len(got) == len(want) == 5
    assert got[0].replace("mem/dev |", "mem/dev (corr) |").replace("fits 80GB", "fits") == want[0]
    assert got[1] == want[1]
    for g, w in zip(got[2:], want[2:]):
        gc, wc = g.split("|"), w.split("|")
        assert gc[:-3] == wc[:-3]  # every column before mem/dev and the fit
        assert wc[-3].strip().startswith(gc[-3].strip()) and gc[-2] == wc[-2]
    assert report.fmt_bytes(13.4e9) == ref_report.fmt_bytes(13.4e9)


def test_report_main_prints_a_table(tmp_path, capsys):
    p = tmp_path / "r.json"
    p.write_text(json.dumps(_records()))
    report.main([str(p)])
    out = capsys.readouterr().out
    assert "(2/3 OK)" in out and "| fits 80GB |" in out and "FAILED: RuntimeError" in out


def test_dryrun_cli_needs_a_cell():
    with pytest.raises(SystemExit):
        dryrun.main([])


def test_meta_routes_keep_the_kernels_checks():
    """The shape-only route refuses what the kernel would refuse, so a
    cell that traces on ``meta`` launches on the card: a head dim the
    flash kernel is not built for, rows of a dtype the rows kernel does
    not take."""
    from repro_torch.kernels.flashattn import flash_attention
    from repro_torch.kernels.fused import cobra_bin_accumulate_rows

    q = torch.empty(1, 2, 8, 48, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    assert flash_attention(*(torch.empty(1, 2, 8, 64, device="meta"),) * 3).shape == (1, 2, 8, 64)
    idx = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="rows kernel takes"):
        cobra_bin_accumulate_rows(idx, torch.empty(4, 3, dtype=torch.float16, device="meta"), 5,
                                  5, 1)
