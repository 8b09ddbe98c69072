"""Dense-tile fast path (block-matmul kernels) vs oracles and chunk path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph
from tcgnn.graph import TiledGraph
from tcgnn.ops.reference import sddmm_ref, spmm_ref
from tcgnn.ops.sddmm import sddmm_tc_dense
from tcgnn.ops.spmm import build_a_tiles, spmm_tc_dense
from tcgnn.sgt.translate import sparse_graph_translate

CFG_SMALL = TileConfig(blk_h=8, blk_w=8, edge_chunk=8)
CFG_DEFAULT = TileConfig()


def make_graph(n, e, seed=0):
    src, dst = powerlaw_graph(n, e, seed=seed)
    return coo_to_csr(src, dst, n)


@pytest.mark.parametrize("cfg", [CFG_SMALL, CFG_DEFAULT])
@pytest.mark.parametrize("n,e,d", [(100, 600, 16), (300, 1500, 50)])
def test_dense_spmm_matches_oracle(cfg, n, e, d):
    indptr, indices = make_graph(n, e, seed=n + d)
    meta = sparse_graph_translate(indptr, indices, n, cfg).as_jax()
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    got = spmm_tc_dense(x, meta, build_a_tiles(meta))
    want = spmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg", [CFG_SMALL, CFG_DEFAULT])
def test_dense_spmm_weighted_matches_oracle(cfg):
    n, e, d = 200, 1200, 24
    indptr, indices = make_graph(n, e, seed=1)
    meta = sparse_graph_translate(indptr, indices, n, cfg).as_jax()
    x = jax.random.normal(jax.random.PRNGKey(1), (n, d), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(2), (len(indices),), jnp.float32)
    got = spmm_tc_dense(x, meta, build_a_tiles(meta, w))
    want = spmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices), edge_weights=w)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg", [CFG_SMALL, CFG_DEFAULT])
@pytest.mark.parametrize("d", [16, 130])
def test_dense_sddmm_matches_oracle(cfg, d):
    n, e = 150, 900
    indptr, indices = make_graph(n, e, seed=9)
    meta = sparse_graph_translate(indptr, indices, n, cfg).as_jax()
    x = jax.random.normal(jax.random.PRNGKey(3), (n, d), jnp.float32)
    got = sddmm_tc_dense(x, meta)
    want = sddmm_ref(x, jnp.asarray(indptr), jnp.asarray(indices))
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4
    )


def test_tiled_graph_auto_selects_dense():
    indptr, indices = make_graph(200, 1000, seed=4)
    g = TiledGraph(indptr, indices, 200, CFG_SMALL)
    assert g.dense_tiles  # tiny graph: dense path on by default
    g2 = TiledGraph(indptr, indices, 200, CFG_SMALL, dense_tiles=False)
    x = jax.random.normal(jax.random.PRNGKey(0), (200, 32), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(g.spmm(x)), np.asarray(g2.spmm(x)), rtol=1e-5, atol=1e-5
    )


def test_dense_and_chunk_grads_agree():
    indptr, indices = make_graph(120, 700, seed=6)
    n = 120
    gd = TiledGraph(indptr, indices, n, CFG_SMALL, dense_tiles=True)
    gc = TiledGraph(indptr, indices, n, CFG_SMALL, dense_tiles=False)
    x = jax.random.normal(jax.random.PRNGKey(7), (n, 20), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(8), (gd.num_edges,), jnp.float32)

    for fn_d, fn_c in [
        (lambda: jax.grad(lambda xx: jnp.sum(jnp.sin(gd.spmm(xx))))(x),
         lambda: jax.grad(lambda xx: jnp.sum(jnp.sin(gc.spmm(xx))))(x)),
        (lambda: jax.grad(lambda xx: jnp.sum(gd.sddmm(xx) ** 2))(x),
         lambda: jax.grad(lambda xx: jnp.sum(gc.sddmm(xx) ** 2))(x)),
    ]:
        np.testing.assert_allclose(
            np.asarray(fn_d()), np.asarray(fn_c()), rtol=1e-4, atol=1e-4
        )

    gw_d = jax.grad(lambda ww: jnp.sum(jnp.cos(gd.spmm_weighted(x, ww))))(w)
    gw_c = jax.grad(lambda ww: jnp.sum(jnp.cos(gc.spmm_weighted(x, ww))))(w)
    np.testing.assert_allclose(np.asarray(gw_d), np.asarray(gw_c), rtol=1e-4, atol=1e-4)


def test_device_struct_tiles_match_host_build():
    """build_struct_tiles (device scatter, edge+block shape bucketing) must
    reproduce the host bincount build exactly — including duplicate-edge
    counts and the dropped padding sentinels."""
    from tcgnn.ops.spmm import build_struct_tiles
    from tcgnn.sgt.translate import build_a_tiles_host

    cfg = CFG_SMALL
    indptr, indices = make_graph(220, 1300, seed=5)
    # inject duplicate edges (multigraph counts > 1)
    indices = np.concatenate([indices, indices[:37]])
    rows = np.repeat(np.arange(220), np.diff(indptr))
    rows = np.concatenate([rows, rows[:37]])
    order = np.lexsort((indices, rows))
    indptr = np.bincount(rows, minlength=220)
    indptr = np.concatenate([[0], np.cumsum(indptr)]).astype(np.int32)
    indices = indices[order].astype(np.int32)

    meta = sparse_graph_translate(indptr, indices, 220, cfg)
    want = build_a_tiles_host(meta)
    # E=1337 is not a bucket size, so the sentinel-padding path runs.
    got, mx = build_struct_tiles(
        jnp.asarray(meta.edge_pos.astype(np.int32)),
        num_blocks=meta.num_blocks, blk_h=cfg.blk_h, blk_w=cfg.blk_w,
    )
    np.testing.assert_array_equal(np.asarray(got), want)
    assert int(mx) == int(want.max())
