"""Window-segment streamed chunk path (sgt/stream.py) vs the oracles.

The streamed ops exist for graphs past the one-shot chunk kernels'
SMEM-prefetch / condensed-slab ceilings (Reddit scale); tests force tiny
per-segment budgets so small graphs exercise multi-segment scans.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph
from tcgnn.graph import TiledGraph
from tcgnn.ops.reference import sddmm_ref, spmm_ref
from tcgnn.ops.sddmm import sddmm_tc_streamed
from tcgnn.ops.spmm import spmm_tc_streamed
from tcgnn.sgt.stream import needs_streaming, segment_chunks
from tcgnn.sgt.translate import sparse_graph_translate

CFG = TileConfig(blk_h=32, blk_w=32, edge_chunk=32)


def make_graph(n, e, seed=0):
    src, dst = powerlaw_graph(n, e, seed=seed)
    indptr, indices = coo_to_csr(src, dst, n)
    return indptr, indices


def make_smeta(indptr, indices, n, *, max_chunks=4, max_slab_rows=256,
               num_segments=None, cfg=CFG):
    host = sparse_graph_translate(indptr, indices, n, cfg, emit_chunks=True,
                                  build_tiles=False)
    return host, segment_chunks(
        host, max_chunks=max_chunks, max_slab_rows=max_slab_rows,
        num_segments=num_segments,
    )


@pytest.mark.parametrize("n,e,d", [(100, 600, 16), (300, 1500, 50)])
def test_streamed_spmm_matches_oracle(n, e, d):
    indptr, indices = make_graph(n, e, seed=n + d)
    _, smeta = make_smeta(indptr, indices, n)
    assert smeta.num_segments > 1  # the point: a real multi-segment scan
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    got = spmm_tc_streamed(x, smeta)
    want = spmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


def test_streamed_spmm_weighted_matches_oracle():
    n, e, d = 200, 1200, 24
    indptr, indices = make_graph(n, e, seed=1)
    _, smeta = make_smeta(indptr, indices, n)
    w = jax.random.normal(jax.random.PRNGKey(2), (len(indices),), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (n, d), jnp.float32)
    got = spmm_tc_streamed(x, smeta, edge_weights=w)
    want = spmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices),
                    edge_weights=w)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [16, 130])
def test_streamed_sddmm_matches_oracle(d):
    n, e = 150, 900
    indptr, indices = make_graph(n, e, seed=9)
    _, smeta = make_smeta(indptr, indices, n)
    x = jax.random.normal(jax.random.PRNGKey(3), (n, d), jnp.float32)
    got = sddmm_tc_streamed(x, smeta)
    want = sddmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_streamed_sddmm_two_matrix():
    n, e, d = 120, 700, 32
    indptr, indices = make_graph(n, e, seed=4)
    _, smeta = make_smeta(indptr, indices, n)
    xa = jax.random.normal(jax.random.PRNGKey(5), (n, d), jnp.float32)
    xb = jax.random.normal(jax.random.PRNGKey(6), (n, d), jnp.float32)
    got = sddmm_tc_streamed(xa, smeta, xb)
    from tcgnn.ops.reference import edge_rows_from_csr

    rows = edge_rows_from_csr(jnp.asarray(indptr), len(indices))
    want = jnp.sum(xa[rows] * xb[jnp.asarray(indices)], axis=1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_segment_count_respects_budgets():
    n, e = 400, 2400
    indptr, indices = make_graph(n, e, seed=7)
    host, smeta = make_smeta(indptr, indices, n, max_chunks=6,
                             max_slab_rows=512)
    # Budgets bound the per-segment maxima — down to the indivisible floor
    # of a single window's own chunk/block counts.
    block_start = np.concatenate([[0], np.cumsum(host.block_partition)])
    per_win_chunks = np.array([
        np.count_nonzero(
            (host.chunk_block >= block_start[w])
            & (host.chunk_block < block_start[w + 1])
        )
        for w in range(host.num_windows)
    ])
    per_win_rows = np.diff(block_start) * host.config.blk_w
    assert smeta.seg_r.shape[1] <= max(6, int(per_win_chunks.max()))
    assert smeta.seg_col_ids.shape[1] <= max(512, int(per_win_rows.max()))
    # segments tile the whole window range
    assert smeta.wseg * smeta.num_segments >= host.num_windows
    assert not needs_streaming(host)  # small graph: auto-gate stays off


def test_tiled_graph_streamed_end_to_end():
    """Forced-streamed TiledGraph: ops + exact gradients vs the dense graph."""
    n, e, d = 220, 1400, 20
    indptr, indices = make_graph(n, e, seed=11)
    g_s = TiledGraph(indptr, indices, n, CFG, dense_tiles=False, streamed=True)
    g_d = TiledGraph(indptr, indices, n, CFG)
    assert g_s.streamed and not g_d.streamed
    x = jax.random.normal(jax.random.PRNGKey(8), (n, d), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(9), (g_s.num_edges,), jnp.float32)

    np.testing.assert_allclose(
        np.asarray(g_s.spmm(x)), np.asarray(g_d.spmm(x)), rtol=1e-5, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(g_s.sddmm(x)), np.asarray(g_d.sddmm(x)), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(g_s.spmm_weighted(x, w)),
        np.asarray(g_d.spmm_weighted(x, w)),
        rtol=1e-5, atol=1e-4,
    )

    def loss_s(x, w):
        return jnp.sum(g_s.spmm_weighted(x, w) ** 2)

    def loss_d(x, w):
        return jnp.sum(g_d.spmm_weighted(x, w) ** 2)

    gx_s, gw_s = jax.grad(loss_s, argnums=(0, 1))(x, w)
    gx_d, gw_d = jax.grad(loss_d, argnums=(0, 1))(x, w)
    np.testing.assert_allclose(np.asarray(gx_s), np.asarray(gx_d),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gw_s), np.asarray(gw_d),
                               rtol=1e-4, atol=1e-3)
