"""Distributed block-diagonal path vs single-device oracle (8-CPU mesh).

A fully-covered component-union graph shards by contiguous 128-row bins;
every op runs as one packed-diagonal contraction per shard with a
nearest-neighbor ppermute rim halo (parallel/blockdiag.py).  These tests
pin the sharded ops — values AND custom-VJP gradients — against the
single-device TiledGraph (itself oracle-tested in test_blockdiag.py), and
check end-to-end trainability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import component_union_graph
from tcgnn.graph import TiledGraph
from tcgnn.models import nets
from tcgnn.parallel import (
    DistributedTiledGraph,
    init_distributed_net,
    make_distributed_train_step,
    make_mesh,
)

# blk_h=128 keeps rows_per_shard a multiple of the 128-row BD bins.
CFG = TileConfig(blk_h=128, blk_w=128, edge_chunk=64)


def union_csr(n, e, num_graphs, seed=0):
    src, dst = component_union_graph(n, e, num_graphs, seed=seed)
    return coo_to_csr(src, dst, n)


@pytest.fixture(scope="module")
def mesh42():
    return make_mesh(n_graph=4, n_feature=2)


@pytest.fixture(scope="module")
def setup(mesh42):
    n, d = 2048, 24
    ptr, cols = union_csr(n=n, e=5200, num_graphs=64, seed=7)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    assert dg.block_diag, "fixture graph must take the BD distributed path"
    sg = TiledGraph(ptr, cols, n, CFG)
    assert sg.block_diag
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.random(dg.num_edges).astype(np.float32)
    return dg, sg, jnp.asarray(x), jnp.asarray(w)


def test_bd_dist_spmm_matches_single(setup):
    dg, sg, x, _ = setup
    n, d = x.shape
    out = jax.jit(dg.spmm)(dg.shard_features(x))
    want = np.asarray(sg.spmm(x))
    np.testing.assert_allclose(
        np.asarray(out)[:n, :d], want, rtol=1e-4, atol=1e-4
    )


def test_bd_dist_spmm_weighted_matches_single(setup):
    dg, sg, x, w = setup
    n, d = x.shape
    ws = dg.edge_weights_to_sharded(np.asarray(w))
    out = jax.jit(dg.spmm_weighted)(dg.shard_features(x), ws)
    want = np.asarray(sg.spmm_weighted(x, w))
    np.testing.assert_allclose(
        np.asarray(out)[:n, :d], want, rtol=1e-4, atol=1e-4
    )


def test_bd_dist_sddmm_matches_single(setup):
    dg, sg, x, _ = setup
    scores = jax.jit(dg.sddmm)(dg.shard_features(x))
    got = dg.gather_edge_vector(scores)
    want = np.asarray(sg.sddmm(x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bd_dist_weighted_grads_match_single(setup):
    dg, sg, x, w = setup
    n, d = x.shape
    xs = dg.shard_features(x)
    ws = dg.edge_weights_to_sharded(np.asarray(w))

    def dloss(xx, ww):
        return jnp.sum(jnp.cos(dg.spmm_weighted(xx, ww)[:n, :d]))

    def sloss(xx, ww):
        return jnp.sum(jnp.cos(sg.spmm_weighted(xx, ww)))

    dgx, dgw = jax.grad(dloss, argnums=(0, 1))(xs, ws)
    sgx, sgw = jax.grad(sloss, argnums=(0, 1))(x, w)
    np.testing.assert_allclose(
        np.asarray(dgx)[:n, :d], np.asarray(sgx), rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        dg.gather_edge_vector(dgw), np.asarray(sgw), rtol=2e-4, atol=2e-4
    )


def test_bd_dist_sddmm_grad_matches_single(setup):
    dg, sg, x, w = setup
    n, d = x.shape
    xs = dg.shard_features(x)
    ws = dg.edge_weights_to_sharded(np.asarray(w))

    def dloss(xx):
        return jnp.sum(dg.sddmm(xx) * ws)

    def sloss(xx):
        return jnp.sum(sg.sddmm(xx) * w)

    dgx = jax.grad(dloss)(xs)
    sgx = jax.grad(sloss)(x)
    np.testing.assert_allclose(
        np.asarray(dgx)[:n, :d], np.asarray(sgx), rtol=2e-4, atol=2e-4
    )


def test_bd_dist_condensed_arrays_skipped(setup):
    dg, _, _, _ = setup
    assert dg._fwd is None and dg._bwd is None


def test_bd_dist_directed_banded_weighted_grads(mesh42):
    """DIRECTED fully-covered banded graph: the transpose machinery (own
    bdm_t extraction, bwd cov slots, edge_fwd_slot routing) must reproduce
    the single-device values and gradients."""
    from tcgnn.data.dataset import coo_to_csr

    n = 2048
    rng = np.random.default_rng(17)
    src = rng.integers(0, n, 6000)
    dst = np.clip(src + rng.integers(-100, 101, 6000), 0, n - 1)
    ptr, cols = coo_to_csr(src, dst, n)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    assert dg.block_diag and not dg.symmetric
    assert dg.agnn_aggregate is None  # fused path is symmetric-only
    sg = TiledGraph(ptr, cols, n, CFG)
    assert sg.block_diag
    x = jnp.asarray(rng.standard_normal((n, 16)).astype(np.float32))
    w = jnp.asarray(rng.random(dg.num_edges).astype(np.float32))
    xs = dg.shard_features(x)
    ws = dg.edge_weights_to_sharded(np.asarray(w))

    out = jax.jit(dg.spmm_weighted)(xs, ws)
    np.testing.assert_allclose(
        np.asarray(out)[:n, :16], np.asarray(sg.spmm_weighted(x, w)),
        rtol=1e-4, atol=1e-4,
    )
    got = dg.gather_edge_vector(jax.jit(dg.sddmm)(xs))
    np.testing.assert_allclose(
        got, np.asarray(sg.sddmm(x)), rtol=1e-4, atol=1e-4
    )

    def dloss(xx, ww):
        return jnp.sum(jnp.cos(dg.spmm_weighted(xx, ww)[:n, :16]))

    def sloss(xx, ww):
        return jnp.sum(jnp.cos(sg.spmm_weighted(xx, ww)))

    dgx, dgw = jax.grad(dloss, argnums=(0, 1))(xs, ws)
    sgx, sgw = jax.grad(sloss, argnums=(0, 1))(x, w)
    np.testing.assert_allclose(
        np.asarray(dgx)[:n, :16], np.asarray(sgx), rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        dg.gather_edge_vector(dgw), np.asarray(sgw), rtol=2e-4, atol=2e-4
    )


def test_bd_dist_gate_misaligned_bins_falls_back(mesh42):
    """rows_per_shard not a multiple of the 128-row bins -> condensed path
    (still correct)."""
    n = 2048
    ptr, cols = union_csr(n=n, e=5200, num_graphs=64, seed=5)
    cfg = TileConfig(blk_h=48, blk_w=48, edge_chunk=48)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, cfg)
    assert not dg.block_diag and dg._fwd is not None
    sg = TiledGraph(ptr, cols, n, cfg)
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal((n, 16)).astype(np.float32)
    )
    out = jax.jit(dg.spmm)(dg.shard_features(x))
    np.testing.assert_allclose(
        np.asarray(out)[:n, :16], np.asarray(sg.spmm(x)),
        rtol=1e-4, atol=1e-4,
    )


def test_bd_dist_gate_powerlaw_falls_back(mesh42):
    """Power-law graphs stay on the condensed distributed design."""
    from tcgnn.data.synthetic import powerlaw_graph

    n = 1024
    src, dst = powerlaw_graph(n, 6000, seed=2)
    from tcgnn.data.dataset import coo_to_csr

    ptr, cols = coo_to_csr(src, dst, n)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    assert not dg.block_diag


def test_bd_dist_fused_agnn_matches_single(setup):
    """Fused packed-diagonal AGNN aggregation on the mesh == single-device
    BD fused path (value, dx, and d_att through the custom VJP)."""
    dg, sg, x, _ = setup
    assert dg.agnn_aggregate is not None and sg.agnn_aggregate is not None
    n, d = x.shape
    att_w = jnp.asarray(np.random.default_rng(3).random((1, 1)).astype(np.float32))
    xs = dg.shard_features(x)

    y_d = jax.jit(dg.agnn_aggregate)(xs, att_w)
    y_s = sg.agnn_aggregate(x, att_w)
    np.testing.assert_allclose(
        np.asarray(y_d)[:n, :d], np.asarray(y_s), rtol=2e-4, atol=2e-4
    )

    def dloss(xx, aw):
        return jnp.sum(jnp.sin(dg.agnn_aggregate(xx, aw)[:n, :d]))

    def sloss(xx, aw):
        return jnp.sum(jnp.sin(sg.agnn_aggregate(xx, aw)))

    dgx, dga = jax.grad(dloss, argnums=(0, 1))(xs, att_w)
    sgx, sga = jax.grad(sloss, argnums=(0, 1))(x, att_w)
    np.testing.assert_allclose(
        np.asarray(dgx)[:n, :d], np.asarray(sgx), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(dga), np.asarray(sga), rtol=2e-3, atol=2e-3
    )


def test_bd_dist_agnn_trains(mesh42):
    """AGNN end-to-end on the BD distributed path (per-edge sddmm +
    weighted spmm, custom VJPs): loss must decrease."""
    n = 2048
    ptr, cols = union_csr(n=n, e=5200, num_graphs=64, seed=9)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    assert dg.block_diag
    rng = np.random.default_rng(1)
    x = dg.shard_features(rng.standard_normal((n, 16)).astype(np.float32))
    y = dg.shard_nodes(rng.integers(0, 4, n).astype(np.int32))
    params, _, _ = init_distributed_net(
        jax.random.PRNGKey(0), "agnn", x.shape[1], 8, 4, 2, dg
    )
    opt = optax.adam(0.01)
    step = make_distributed_train_step(
        dg, "agnn", x, y, opt, dropout_rate=0.0, num_valid_classes=4
    )
    state = opt.init(params)
    losses = []
    key = jax.random.PRNGKey(1)
    for _ in range(5):
        key, k = jax.random.split(key)
        params, state, _, loss = step(params, state, k)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
