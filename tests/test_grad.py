"""Gradient correctness: custom VJPs vs autodiff through the oracles.

The reference never verifies gradients (backward is aliased to forward
assuming symmetry, TCGNN.cpp:270; AGNN's attention grad is ad hoc,
gnn_conv.py:150-158).  Here every op's custom VJP is checked against plain
JAX autodiff of the segment-sum oracle — on *directed* graphs, so the
transpose path is genuinely exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.graph import TiledGraph
from tcgnn.models import nets
from tcgnn.ops.reference import edge_rows_from_csr, spmm_ref, sddmm_ref

CFG = TileConfig(blk_h=8, blk_w=8, edge_chunk=8)


def directed_graph(n, e, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = src != dst
    return coo_to_csr(src[keep], dst[keep], n)


@pytest.fixture(scope="module")
def setup():
    n, e, d = 60, 400, 12
    indptr, indices = directed_graph(n, e)
    graph = TiledGraph(indptr, indices, n, CFG)
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    return graph, jnp.asarray(indptr), jnp.asarray(indices), x


def test_spmm_grad(setup):
    graph, indptr, indices, x = setup
    g = jax.grad(lambda x: jnp.sum(jnp.sin(graph.spmm(x))))(x)
    g_ref = jax.grad(lambda x: jnp.sum(jnp.sin(spmm_ref(x, indptr, indices))))(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-4, atol=1e-5)


def test_spmm_weighted_grads(setup):
    graph, indptr, indices, x = setup
    ne = graph.num_edges
    w = jax.random.normal(jax.random.PRNGKey(1), (ne,), jnp.float32)

    def f(x, w):
        return jnp.sum(jnp.cos(graph.spmm_weighted(x, w)))

    def f_ref(x, w):
        return jnp.sum(jnp.cos(spmm_ref(x, indptr, indices, edge_weights=w)))

    gx, gw = jax.grad(f, argnums=(0, 1))(x, w)
    gx_ref, gw_ref = jax.grad(f_ref, argnums=(0, 1))(x, w)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(gx_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gw), np.asarray(gw_ref), rtol=1e-4, atol=1e-5)


def test_sddmm_grad(setup):
    graph, indptr, indices, x = setup
    g = jax.grad(lambda x: jnp.sum(jnp.tanh(graph.sddmm(x))))(x)
    g_ref = jax.grad(lambda x: jnp.sum(jnp.tanh(sddmm_ref(x, indptr, indices))))(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["gcn", "gin", "agnn"])
def test_model_grads_match_oracle(kind, setup):
    """Full net gradients (params) vs the same net built on oracle ops."""
    graph, indptr, indices, x = setup
    n = x.shape[0]
    y = jnp.asarray(np.random.default_rng(2).integers(0, 5, n))
    params = nets.init_net(jax.random.PRNGKey(3), kind, x.shape[1], 8, 5, 3, init="uniform")

    def loss_tc(params):
        logp = nets.apply_net(params, kind, x, graph)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    # Oracle version of the same model.
    class OracleGraph:
        def spmm(self, x):
            return spmm_ref(x, indptr, indices)

        def spmm_weighted(self, x, w):
            return spmm_ref(x, indptr, indices, edge_weights=w)

        def sddmm(self, x):
            return sddmm_ref(x, indptr, indices)

    def loss_ref(params):
        logp = nets.apply_net(params, kind, x, OracleGraph())
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    l_tc, g_tc = jax.value_and_grad(loss_tc)(params)
    l_ref, g_ref = jax.value_and_grad(loss_ref)(params)
    np.testing.assert_allclose(float(l_tc), float(l_ref), rtol=1e-5)
    for p_tc, p_ref in zip(jax.tree.leaves(g_tc), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(
            np.asarray(p_tc), np.asarray(p_ref), rtol=1e-3, atol=1e-4
        )
