"""Zamba2's gradients across a boundary of Mamba2's 64-token chunks, held
to float64 on the CPU against the JAX package.

``chip_smoke.py`` phase 18 holds a one-cycle full-width float32 zamba2
step on the card to the same step on the CPU. At 128 tokens, two of
Mamba2's 64-token chunks, the gradients differed by 1.5e-3 of max |g|
(9.7e-5 at 256). A fault of the chunked SSD at a chunk boundary would look
like that, and so would float32 conditioning; ``scripts/
torch_zamba2_witness.py`` tells them apart on the card at full width. This
file pins the CPU's side at the reduced width with the full config's chunk
(64) and the phase's batch shape (``SyntheticLM``, B 1 x S 128, so one
boundary at 64), on the reference's weights:

- the port's float64 gradients (the witness's float64 run: the model in
  float64, ``Tensor.float()`` promoted, RoPE's angles in float64, plain
  attention and embedding) equal the reference's float64 gradients
  (``jax.enable_x64``, its float32 casts promoted) within ``FLOAT64_TOL``
  of each leaf's max |g| (measured 1.8e-13; 1.2e-6 with the port's
  float32 RoPE frequencies): the two packages compute the same function
  across the boundary;
- the port's float32 gradients lie within ``FLOAT32_TOL`` of the float64
  ones (measured 7.6e-5, the reference's own float32 7.7e-5, both at
  Mamba2's ``norm_w``), and their worst leaf no farther than
  ``WITNESS_RATIO`` times the reference's.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import ssm as RSSM
from repro.models import transformer as RT
from repro.models.params import unbox
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.train.optimizer import reference_leaf

ARCH = "zamba2-2.7b"
CFG_KW = dict(mlstm_chunk=64)  # the full config's chunk
SEQ = 128  # two chunks
FLOAT64_TOL = 1e-9
FLOAT32_TOL = 1e-4
WITNESS_RATIO = 1.5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _witness():
    spec = importlib.util.spec_from_file_location(
        "torch_zamba2_witness", os.path.join(ROOT, "scripts", "torch_zamba2_witness.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Float64:
    """``jax.numpy`` with its ``float32`` (and the loss's ``int32`` count)
    promoted, for the reference's model modules under ``jax.enable_x64``."""
    float32 = jnp.float64
    int32 = jnp.int64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _ref_loss_fn(rcfg):
    def loss_fn(params, batch):
        hidden, _ = RT.hidden_forward(params, batch["tokens"], rcfg)
        return RT.chunked_lm_loss(params, hidden, batch["labels"], rcfg, chunk=rcfg.loss_chunk)
    return loss_fn


def _leaf(tree, name):
    key, index = reference_leaf(name)
    node = tree
    for k in key.split("."):
        node = node[k]
    node = np.asarray(node, dtype=np.float64)
    return node if index is None else node[index]


@pytest.fixture(scope="module")
def grads(monkeypatch_module):
    rcfg = ref_get_config(ARCH).reduced(**CFG_KW)
    cfg = get_config(ARCH).reduced(**CFG_KW)
    assert cfg.mlstm_chunk == rcfg.mlstm_chunk == 64
    rparams = jax.jit(lambda key: unbox(RT.init_params(key, rcfg))[0])(jax.random.PRNGKey(0))
    p_np = jax.tree.map(np.asarray, rparams)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                   global_batch=1)).batch_at(0)
    assert batch["tokens"].shape == (1, SEQ)
    jb = jax.tree.map(jnp.asarray, batch)
    ref32 = jax.tree.map(np.asarray, jax.jit(jax.grad(_ref_loss_fn(rcfg)))(rparams, jb))
    cfg64 = dataclasses.replace(rcfg, param_dtype="float64", compute_dtype="float64")
    with monkeypatch_module.context() as m, jax.enable_x64(True):
        for mod in (RT, RSSM, RL):
            m.setattr(mod, "jnp", _Float64())
        p64 = jax.tree.map(lambda a: jnp.asarray(a.astype(np.float64)), p_np)
        ref64 = jax.tree.map(np.asarray, jax.grad(_ref_loss_fn(cfg64))(
            p64, jax.tree.map(jnp.asarray, batch)))
    w = _witness()
    model = lm_params_from_numpy(p_np, cfg, device="cpu")
    _, port32 = w.grads(model, cfg, batch)
    _, port64, _ = w.float64_grads(model, cfg, batch)
    names = list(port32)
    true = {n: _leaf(ref64, n) for n in names}
    return names, true, {n: port32[n].numpy() for n in names}, \
        {n: port64[n].numpy() for n in names}, {n: _leaf(ref32, n) for n in names}


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as m:
        yield m


def _share(a, b):
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)


def test_port_float64_equals_reference_float64_across_the_chunk_boundary(grads):
    names, true, _, port64, _ = grads
    for n in names:
        assert _share(port64[n], true[n]) <= FLOAT64_TOL, n


def test_port_float32_is_as_close_to_float64_as_the_reference(grads):
    names, true, port32, _, ref32 = grads
    port = max(_share(port32[n], true[n]) for n in names)
    ref = max(_share(ref32[n], true[n]) for n in names)
    assert port <= FLOAT32_TOL, (port, ref)
    assert port <= WITNESS_RATIO * ref, (port, ref)
