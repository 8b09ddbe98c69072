"""Distributed STREAMED composition (Reddit-scale path) vs oracles.

Each shard lax.scans one compiled chunk kernel over its window segments
inside the shard map (``parallel.graph._build_ops_streamed``) — the
single-chip streamed path (``sgt/stream.py``) composed with the
window-aligned partition.  ``_stream_limits`` forces multi-segment
streams on small graphs so the full machinery runs on the CPU mesh.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph
from tcgnn.graph import TiledGraph
from tcgnn.parallel import make_mesh
from tcgnn.parallel.graph import DistributedTiledGraph
from tcgnn.parallel.train import (
    init_distributed_net,
    make_distributed_train_step,
)

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)
# Tiny per-segment ceilings: every shard streams several segments.
LIMITS = (8, 24 * 16)


def _graph(n=430, e=2600, seed=7):
    src, dst = powerlaw_graph(n, e, seed=seed)
    return coo_to_csr(src, dst, n), n


@pytest.fixture
def mesh41():
    return make_mesh(n_graph=4, n_feature=1)


def _dist(ptr, cols, n, mesh):
    dg = DistributedTiledGraph(
        ptr, cols, n, mesh, CFG, streamed=True, _stream_limits=LIMITS,
    )
    assert dg.streamed
    assert dg._stream_static[0]["num_segments"] > 1  # forced multi-segment
    return dg

def test_streamed_spmm_matches_single_device(mesh41):
    (ptr, cols), n = _graph()
    dg = _dist(ptr, cols, n, mesh41)
    g1 = TiledGraph(ptr, cols, n, CFG)
    x_host = np.random.default_rng(0).standard_normal((n, 24)).astype(np.float32)
    xs = dg.shard_features(x_host)
    got = np.asarray(dg.spmm(xs))[:n, :24]
    want = np.asarray(g1.spmm(jnp.asarray(x_host)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_streamed_weighted_and_sddmm_match(mesh41):
    (ptr, cols), n = _graph(seed=11)
    dg = _dist(ptr, cols, n, mesh41)
    g1 = TiledGraph(ptr, cols, n, CFG)
    rng = np.random.default_rng(1)
    x_host = rng.standard_normal((n, 16)).astype(np.float32)
    w_host = rng.standard_normal(len(cols)).astype(np.float32)
    xs = dg.shard_features(x_host)
    ws = dg.edge_weights_to_sharded(w_host)

    got_w = np.asarray(dg.spmm_weighted(xs, ws))[:n, :16]
    want_w = np.asarray(
        g1.spmm_weighted(jnp.asarray(x_host), jnp.asarray(w_host))
    )
    np.testing.assert_allclose(got_w, want_w, rtol=1e-4, atol=1e-4)

    got_s = dg.gather_edge_vector(dg.sddmm(xs))
    want_s = np.asarray(g1.sddmm(jnp.asarray(x_host)))
    np.testing.assert_allclose(got_s, want_s, rtol=1e-4, atol=1e-4)


def test_streamed_training_step_decreases_loss(mesh41):
    (ptr, cols), n = _graph(seed=3)
    dg = _dist(ptr, cols, n, mesh41)
    rng = np.random.default_rng(2)
    x = dg.shard_features(rng.standard_normal((n, 12)).astype(np.float32))
    y = dg.shard_nodes(rng.integers(0, 4, n).astype(np.int32))
    params, _, _ = init_distributed_net(
        jax.random.PRNGKey(0), "gcn", x.shape[1], 8, 4, 2, dg
    )
    opt = optax.adam(0.01)
    st = opt.init(params)
    step = make_distributed_train_step(
        dg, "gcn", x, y, opt, 0.0, num_valid_classes=4
    )
    key = jax.random.PRNGKey(1)
    losses = []
    for _ in range(5):
        params, st, key, loss = step(params, st, key)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_streamed_grad_matches_single_device(mesh41):
    """Backward through the streamed distributed spmm == single-device."""
    (ptr, cols), n = _graph(seed=5)
    dg = _dist(ptr, cols, n, mesh41)
    g1 = TiledGraph(ptr, cols, n, CFG)
    x_host = np.random.default_rng(4).standard_normal((n, 8)).astype(np.float32)

    def loss_d(x):
        return jnp.sum(dg.spmm(x)[:n] ** 2)

    def loss_1(x):
        return jnp.sum(g1.spmm(x) ** 2)

    gd = np.asarray(jax.grad(loss_d)(dg.shard_features(x_host)))[:n, :8]
    g1_ = np.asarray(jax.grad(loss_1)(jnp.asarray(x_host)))
    np.testing.assert_allclose(gd, g1_, rtol=1e-3, atol=1e-3)


def test_streamed_feature_sharded_matches_single_device():
    """pf=2: per-feature-shard aggregation + the SDDMM's feature psum."""
    mesh = make_mesh(n_graph=2, n_feature=2)
    (ptr, cols), n = _graph(seed=13)
    dg = DistributedTiledGraph(
        ptr, cols, n, mesh, CFG, streamed=True, _stream_limits=LIMITS,
    )
    assert dg.streamed and dg.pf == 2
    g1 = TiledGraph(ptr, cols, n, CFG)
    rng = np.random.default_rng(5)
    x_host = rng.standard_normal((n, 32)).astype(np.float32)
    xs = dg.shard_features(x_host)

    got = np.asarray(dg.spmm(xs))[:n, :32]
    want = np.asarray(g1.spmm(jnp.asarray(x_host)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    got_s = dg.gather_edge_vector(dg.sddmm(xs))
    want_s = np.asarray(g1.sddmm(jnp.asarray(x_host)))
    np.testing.assert_allclose(got_s, want_s, rtol=1e-4, atol=1e-4)
