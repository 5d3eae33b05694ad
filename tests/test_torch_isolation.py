"""The port stands alone: no JAX and nothing of ``repro`` at run time.

A subprocess imports every ``repro_torch`` module and checks that neither
``jax`` nor ``repro`` was loaded; an AST scan of the package and of
``chip_smoke.py`` finds no such import; and ``chip_smoke.py`` refuses to
run (non-zero exit, no result line) without CUDA and outside the repo.
"""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), os.path.join(ROOT, "src"))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.core.executor" in mods and "repro_torch.kernels.fused" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_moe_path_and_the_cost_models_run_without_jax_or_repro():
    """Not only imports: a reduced MoE model's prefill and decode (both
    dispatch methods) and a roofline evaluated in one process that never
    loads ``jax`` or ``repro``."""
    mods = _modules()
    assert "repro_torch.roofline" in mods and "repro_torch.core.traffic" in mods
    code = (
        "import dataclasses, json, sys, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import transformer as T\n"
        "from repro_torch.roofline import ShardedPBStreamRoofline\n"
        "from repro_torch.train.steps import make_decode_step, make_prefill_step\n"
        "for method in ('sort', 'counting'):\n"
        "    cfg = get_config('qwen3-moe-235b-a22b').reduced(moe_dispatch_method=method)\n"
        "    model = T.init_params(cfg, seed=0, device='cpu')\n"
        "    logits, st = make_prefill_step(cfg, 16)(model, {'tokens': torch.ones(1, 5, dtype=torch.int32)})\n"
        "    make_decode_step(cfg)(model, st, torch.ones(1, 1, dtype=torch.int32))\n"
        "assert ShardedPBStreamRoofline(1 << 20, 1 << 16, 4).best_pipeline_chunks() >= 1\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_recurrent_families_run_without_jax_or_repro():
    """A reduced xLSTM and a reduced Zamba2 (``models/ssm.py`` on both
    paths: the chunked prefill and the one-token decode) in one process
    that never loads ``jax`` or ``repro``."""
    mods = _modules()
    assert "repro_torch.models.ssm" in mods
    code = (
        "import json, sys, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import transformer as T\n"
        "from repro_torch.train.steps import make_decode_step, make_prefill_step\n"
        "for arch in ('xlstm-350m', 'zamba2-2.7b'):\n"
        "    cfg = get_config(arch).reduced()\n"
        "    model = T.init_params(cfg, seed=0, device='cpu')\n"
        "    logits, st = make_prefill_step(cfg, 32)(model, {'tokens': torch.ones(1, 20, dtype=torch.int32)})\n"
        "    make_decode_step(cfg)(model, st, torch.ones(1, 1, dtype=torch.int32))\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")] + [SMOKE]
))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            bad = [node.module] if node.module and _forbidden(node.module) else []
        else:
            continue
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True, env=env, timeout=300
    )


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return not lines or '"ok"' not in lines[-1]


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run in full")
    out = _run_smoke(ROOT, SMOKE)
    assert out.returncode != 0 and _no_result(out)
    assert "CUDA" in out.stderr + out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0 and _no_result(out)
