"""The GNN path of the port against the reference's ``models/layers.py``.

The same numpy graph and features go through ``repro.models.layers`` (JAX
on the CPU) and ``repro_torch.models``; on CPU tensors the port's fused
reduce runs its plain version. Forward results agree within rtol/atol
1e-5 and gradients within rtol/atol 1e-4 (``tests/test_gnn.py``'s own
tolerances: both sides sum float32 in different orders). The max
subgradient with ties must match exactly: every attaining in-neighbour
receives the full cotangent.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as L
from repro.core import COO as RCOO
from repro.core.neighbor_populate import build_csr_csc as r_build_csr_csc
from repro.models.params import unbox
from repro_torch.convert import coo_from_numpy, gnn_layer_from_numpy, to_numpy
from repro_torch.core.neighbor_populate import build_csr_csc as t_build_csr_csc
from repro_torch.models import GNNLayer, gnn_aggregate


def _graph(n=30, m=150, seed=5):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    src[: m // 10] = src[0]  # duplicate edges: multiplicity counts
    dst[: m // 10] = dst[0]
    return src, dst, n


def _both(src, dst, n):
    rcsr, rcsc = r_build_csr_csc(RCOO(jnp.asarray(src), jnp.asarray(dst), n))
    tcsr, tcsc = t_build_csr_csc(coo_from_numpy(src, dst, n, device="cpu"))
    return (rcsr, rcsc), (tcsr, tcsc)


def _close(t, r, tol):
    np.testing.assert_allclose(to_numpy(t), np.asarray(r), rtol=tol, atol=tol)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("F", [1, 5])
def test_gnn_aggregate_forward_matches_reference(op, F):
    src, dst, n = _graph()
    (rcsr, rcsc), (tcsr, tcsc) = _both(src, dst, n)
    h = np.random.default_rng(7).standard_normal((n, F)).astype(np.float32)
    want = L.gnn_aggregate(jnp.asarray(h), rcsc, rcsr, op=op)
    got = gnn_aggregate(torch.from_numpy(h), tcsc, tcsr, op=op)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_gnn_aggregate_grad_matches_jax(op):
    src, dst, n = _graph(seed=9)
    (rcsr, rcsc), (tcsr, tcsc) = _both(src, dst, n)
    rng = np.random.default_rng(11)
    h = rng.standard_normal((n, 4)).astype(np.float32)
    w = rng.standard_normal((n, 4)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(L.gnn_aggregate(x, rcsc, rcsr, op=op) * jnp.asarray(w)))(
        jnp.asarray(h)
    )
    th = torch.from_numpy(h).requires_grad_(True)
    (gnn_aggregate(th, tcsc, tcsr, op=op) * torch.from_numpy(w)).sum().backward()
    _close(th.grad, want, 1e-4)


def test_gnn_aggregate_max_grad_ties_get_full_cotangent():
    """``tests/test_gnn.py:88``'s engineered tie: v3 <- {0, 1} with
    h[0] == h[1], v4 <- {0, 2}, v5 <- {2}."""
    n = 6
    src = np.array([0, 1, 0, 2, 2], np.int32)
    dst = np.array([3, 3, 4, 4, 5], np.int32)
    (rcsr, rcsc), (tcsr, tcsc) = _both(src, dst, n)
    h = np.array([[2.0], [2.0], [1.0], [0.0], [0.0], [0.0]], np.float32)
    w = np.array([[0.0], [0.0], [0.0], [5.0], [7.0], [11.0]], np.float32)
    want = jax.grad(
        lambda x: jnp.sum(L.gnn_aggregate(x, rcsc, rcsr, op="max") * jnp.asarray(w))
    )(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    (gnn_aggregate(th, tcsc, tcsr, op="max") * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(to_numpy(th.grad), np.asarray(want))
    np.testing.assert_array_equal(to_numpy(th.grad)[:, 0], [12.0, 5.0, 11.0, 0.0, 0.0, 0.0])


def test_gnn_aggregate_validation_and_empty():
    src, dst, n = _graph()
    _, (tcsr, tcsc) = _both(src, dst, n)
    h = torch.zeros(n, 3)
    with pytest.raises(ValueError, match="sum|mean|max"):
        gnn_aggregate(h, tcsc, tcsr, op="median")
    with pytest.raises(ValueError, match="num_nodes"):
        gnn_aggregate(torch.zeros(7, 3), tcsc, tcsr)
    e = np.zeros(0, np.int32)
    _, (ecsr, ecsc) = _both(e, e, 8)
    assert float(gnn_aggregate(torch.ones(8, 3), ecsc, ecsr, op="max").abs().sum()) == 0.0
    out = to_numpy(gnn_aggregate(h - 5.0, tcsc, tcsr, op="max"))
    indeg = np.bincount(dst, minlength=n)
    assert (out[indeg == 0] == 0).all()  # isolated vertices: 0, not the identity


def _layer_pair(d_in, d_out, seed=0):
    p, _ = unbox(L.init_gnn_layer(jax.random.PRNGKey(seed), d_in, d_out))
    return p, gnn_layer_from_numpy({k: np.asarray(v) for k, v in p.items()}, device="cpu")


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_gnn_layer_matches_reference_forward_and_param_grads(agg):
    src, dst, n = _graph(seed=13)
    (rcsr, rcsc), (tcsr, tcsc) = _both(src, dst, n)
    d_in, d_out = 6, 5
    p, layer = _layer_pair(d_in, d_out)
    h = np.random.default_rng(1).standard_normal((n, d_in)).astype(np.float32)
    want = L.gnn_layer_apply(p, jnp.asarray(h), rcsc, rcsr, agg=agg)
    got = layer(torch.from_numpy(h), tcsc, tcsr, agg=agg)  # gnn_layer_apply
    assert got.shape == (n, d_out)
    _close(got.detach(), want, 1e-5)
    grads = jax.grad(
        lambda q: jnp.sum(L.gnn_layer_apply(q, jnp.asarray(h), rcsc, rcsr, agg=agg) ** 2)
    )(p)
    (got ** 2).sum().backward()
    for name in ("w_msg", "w_self", "b"):
        g = getattr(layer, name).grad
        assert g is not None and float(g.abs().sum()) > 0, name
        _close(g, grads[name], 1e-4)


def test_gnn_layer_init_is_a_seeded_truncated_normal():
    a = GNNLayer(64, 32, generator=torch.Generator().manual_seed(3), device="cpu")
    b = GNNLayer(64, 32, generator=torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a.w_msg, b.w_msg) and torch.equal(a.w_self, b.w_self)
    assert not torch.equal(a.w_msg, a.w_self)
    bound = 2.0 * 64 ** -0.5  # [-2, 2] standard deviations at fan-in scale
    for w in (a.w_msg.detach(), a.w_self.detach()):
        assert w.shape == (64, 32) and float(w.abs().max()) <= bound
        assert 0.7 * 64 ** -0.5 < float(w.std()) < 1.0 * 64 ** -0.5
    assert float(a.b.detach().abs().sum()) == 0.0
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            GNNLayer(4, 4)
