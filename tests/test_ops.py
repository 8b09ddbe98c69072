"""Chunk-route SpMM / SDDMM vs the dense segment-sum oracles (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph
from tcgnn.ops.reference import sddmm_ref, spmm_ref
from tcgnn.ops.sddmm import sddmm_tc
from tcgnn.ops.spmm import spmm_tc
from tcgnn.sgt.translate import sparse_graph_translate

CFG_SMALL = TileConfig(blk_h=8, blk_w=8, edge_chunk=8)
CFG_DEFAULT = TileConfig()  # 128/128/128


def make_graph(n, e, seed=0):
    src, dst = powerlaw_graph(n, e, seed=seed)
    indptr, indices = coo_to_csr(src, dst, n)
    return indptr, indices


@pytest.mark.parametrize("cfg", [CFG_SMALL, CFG_DEFAULT])
@pytest.mark.parametrize("n,e,d", [(100, 600, 16), (300, 1500, 50)])
def test_spmm_matches_oracle(cfg, n, e, d):
    indptr, indices = make_graph(n, e, seed=n + d)
    meta = sparse_graph_translate(indptr, indices, n, cfg).as_jax()
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    got = spmm_tc(x, meta)
    want = spmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices))
    # atol 1e-4: hub rows sum hundreds of f32 terms in tile order vs the
    # oracle's segment order; bit-identity is not expected.
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cfg", [CFG_SMALL, CFG_DEFAULT])
def test_spmm_weighted_matches_oracle(cfg):
    n, e, d = 200, 1200, 24
    indptr, indices = make_graph(n, e, seed=1)
    meta = sparse_graph_translate(indptr, indices, n, cfg).as_jax()
    num_edges = len(indices)
    key = jax.random.PRNGKey(1)
    x = jax.random.normal(key, (n, d), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(2), (num_edges,), jnp.float32)
    got = spmm_tc(x, meta, edge_weights=w)
    want = spmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices), edge_weights=w)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg", [CFG_SMALL, CFG_DEFAULT])
@pytest.mark.parametrize("d", [16, 130])
def test_sddmm_matches_oracle(cfg, d):
    n, e = 150, 900
    indptr, indices = make_graph(n, e, seed=9)
    meta = sparse_graph_translate(indptr, indices, n, cfg).as_jax()
    x = jax.random.normal(jax.random.PRNGKey(3), (n, d), jnp.float32)
    got = sddmm_tc(x, meta)
    want = sddmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_sddmm_two_matrix():
    """xa != xb: the exact edge-weight gradient path for weighted SpMM."""
    n, e, d = 120, 700, 32
    indptr, indices = make_graph(n, e, seed=4)
    meta = sparse_graph_translate(indptr, indices, n, CFG_SMALL).as_jax()
    xa = jax.random.normal(jax.random.PRNGKey(5), (n, d), jnp.float32)
    xb = jax.random.normal(jax.random.PRNGKey(6), (n, d), jnp.float32)
    got = sddmm_tc(xa, meta, xb)
    # Oracle with two matrices.
    from tcgnn.ops.reference import edge_rows_from_csr

    rows = edge_rows_from_csr(jnp.asarray(indptr), len(indices))
    want = jnp.sum(xa[rows] * xb[jnp.asarray(indices)], axis=-1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_spmm_isolated_nodes():
    """Graph with trailing isolated nodes (empty windows must still zero out)."""
    n = 300  # nodes 200.. have no edges
    src = np.random.default_rng(0).integers(0, 200, 800)
    dst = np.random.default_rng(1).integers(0, 200, 800)
    indptr, indices = coo_to_csr(src, dst, n)
    meta = sparse_graph_translate(indptr, indices, n, CFG_SMALL).as_jax()
    x = jax.random.normal(jax.random.PRNGKey(7), (n, 16), jnp.float32)
    got = spmm_tc(x, meta)
    want = spmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices))
    # atol 1e-4: hub rows sum hundreds of f32 terms in tile order vs the
    # oracle's segment order; bit-identity is not expected.
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-4)
    assert np.abs(np.asarray(got[250:])).max() == 0.0


def test_sddmm_edge_dot_route_matches_oracle(monkeypatch):
    """Hub-graph edge-dot SDDMM route (graph.SDDMM_EDGE_DOT_BYTES): forcing
    it on a small graph must match both the tile-path extraction and the
    dense oracle — same semantics, no score-tile materialization."""
    import tcgnn.graph as G
    from tcgnn.graph import TiledGraph

    n, e = 260, 1600
    indptr, indices = make_graph(n, e, seed=21)
    cfg = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)
    x = jax.random.normal(jax.random.PRNGKey(5), (n, 20), jnp.float32)

    g_plain = TiledGraph(indptr, indices, n, cfg, block_diag=False)
    want = np.asarray(g_plain.sddmm(x))

    monkeypatch.setattr(G, "SDDMM_EDGE_DOT_BYTES", 0)
    g_ed = TiledGraph(indptr, indices, n, cfg, block_diag=False)
    got = np.asarray(g_ed.sddmm(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    oracle = np.asarray(
        sddmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices))
    )
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)

    # gradient flows through the edge-dot route exactly like the tile path
    def loss(g, xx):
        return jnp.sum(g.sddmm(xx) ** 2)

    g_a = np.asarray(jax.grad(lambda xx: loss(g_ed, xx))(x))
    g_b = np.asarray(jax.grad(lambda xx: loss(g_plain, xx))(x))
    np.testing.assert_allclose(g_a, g_b, rtol=1e-4, atol=1e-4)
