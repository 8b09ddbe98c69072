"""Mega-window block-stream split (parallel/partition.build_split).

After a bandwidth ordering, one or two hub windows hold most of a
power-law graph's blocks (amazon0601: 87% in 2 of 788 windows), so no
window→shard assignment balances the mesh. The split lets underloaded
shards compute consecutive tail slices of overloaded windows as guest
output windows and returns partial tiles to the owners with one small
all_to_all. These tests force the split with a planted mega-window and
check exactness (fwd + grad vs the single-device op), the stacked-grid
reduction, and the end-to-end training step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tcgnn.config import TileConfig
from tcgnn.graph import TiledGraph
from tcgnn.ops.reference import spmm_ref
from tcgnn.parallel import (
    DistributedTiledGraph,
    init_distributed_net,
    make_distributed_train_step,
    make_mesh,
)

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)


def mega_csr(n, hub_rows=16, hub_deg=160, seed=0, symmetric=False):
    """Random sparse graph with one dense (mega) row window at the front."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, n).clip(0, n - 1)
    deg[:hub_rows] = hub_deg
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    if symmetric:
        import scipy.sparse as sp

        rows = np.repeat(np.arange(n), [len(c) for c in cols])
        a = sp.csr_matrix(
            (np.ones(len(rows)), (rows, np.concatenate(cols))), shape=(n, n)
        )
        a = ((a + a.T) > 0).astype(np.int8).tocsr()
        return a.indptr.astype(np.int32), a.indices.astype(np.int32)
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    return ptr.astype(np.int32), np.concatenate(cols).astype(np.int32)


@pytest.fixture(scope="module")
def mesh42():
    return make_mesh(n_graph=4, n_feature=2)


def test_split_engages_and_shrinks_grid(mesh42):
    n = 400
    ptr, cols = mega_csr(n)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    sp = dg.host_fwd.split
    assert sp is not None, "mega-window graph must trigger the split"
    # Unsplit stacked grid is bounded below by the mega window's block count.
    unsplit = DistributedTiledGraph(ptr, cols, n, mesh42, CFG, split=False)
    assert unsplit.host_fwd.split is None
    b_unsplit = unsplit.host_fwd.a_tiles.shape[1]
    b_split = sp["a_tiles"].shape[1]
    assert b_split < b_unsplit
    # Total real work is conserved: guests are slices, not copies.
    assert int((sp["a_tiles"].sum(axis=(2, 3)) > 0).sum()) <= b_unsplit * dg.pg


def test_split_spmm_fwd_and_grad_exact(mesh42):
    n, d = 400, 24
    ptr, cols = mega_csr(n, symmetric=True)  # symmetric -> both sides split
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    assert dg.host_fwd.split is not None and dg.host_bwd.split is not None
    x = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    out = jax.jit(dg.spmm)(dg.shard_features(x))
    want = np.asarray(spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols)))
    np.testing.assert_allclose(np.asarray(out)[:n, :d], want, rtol=1e-4, atol=1e-4)

    sg = TiledGraph(ptr, cols, n, CFG)
    g_d = jax.grad(lambda v: jnp.sum(dg.spmm(v) ** 2))(dg.shard_features(x))
    g_s = np.asarray(jax.grad(lambda v: jnp.sum(sg.spmm(v) ** 2))(jnp.asarray(x)))
    np.testing.assert_allclose(
        np.asarray(g_d)[:n, :d], g_s[:n, :d], rtol=1e-3, atol=1e-3
    )


def test_split_train_step_decreases_loss(mesh42):
    n = 400
    ptr, cols = mega_csr(n, seed=3)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    assert dg.host_fwd.split is not None
    rng = np.random.default_rng(0)
    x = dg.shard_features(rng.standard_normal((n, 32)).astype(np.float32))
    y = dg.shard_nodes((rng.integers(0, 5, n)).astype(np.int32))
    params, _, _ = init_distributed_net(
        jax.random.PRNGKey(0), "gcn", x.shape[1], 16, 5, 2, dg
    )
    opt = optax.adam(0.01)
    st = opt.init(params)
    step = make_distributed_train_step(dg, "gcn", x, y, opt, 0.0, num_valid_classes=5)
    key = jax.random.PRNGKey(1)
    losses = []
    for _ in range(5):
        params, st, key, loss = step(params, st, key)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_split_weighted_spmm_fwd_exact(mesh42):
    """The weighted SpMM rides the split stream: tiles are rebuilt on the
    computing shard from the all-gathered edge vector (edge_pos/w_src)."""
    n, d = 400, 16
    ptr, cols = mega_csr(n, symmetric=True, seed=4)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    assert dg.host_fwd.split is not None
    assert "w_src" in dg.host_fwd.split and "w_src" in dg.host_bwd.split
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(dg.num_edges).astype(np.float32)
    xs = dg.shard_features(x)
    ws = dg.edge_weights_to_sharded(w)
    out = jax.jit(dg.spmm_weighted)(xs, ws)
    want = np.asarray(
        spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols), jnp.asarray(w))
    )
    np.testing.assert_allclose(np.asarray(out)[:n, :d], want, rtol=1e-4, atol=1e-4)
    # sddmm (per-edge outputs, deliberately unsplit) still agrees
    e = dg.gather_edge_vector(jax.jit(dg.sddmm)(xs))
    rows = np.repeat(np.arange(n), np.diff(ptr))
    np.testing.assert_allclose(
        e, np.einsum("ed,ed->e", x[rows], x[cols]), rtol=1e-4, atol=1e-4
    )


def test_split_weighted_spmm_grads_exact(mesh42):
    """Weighted-split gradients (dx rides the transpose split stream whose
    w_src was remapped to forward slots; dw is the unsplit SDDMM)."""
    n, d = 400, 16
    ptr, cols = mega_csr(n, symmetric=True, seed=5)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    assert dg.host_fwd.split is not None and dg.host_bwd.split is not None
    sg = TiledGraph(ptr, cols, n, CFG)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(dg.num_edges).astype(np.float32)
    xs = dg.shard_features(x)
    ws = dg.edge_weights_to_sharded(w)

    def loss_d(xx, ww):
        return jnp.sum(jnp.cos(dg.spmm_weighted(xx, ww)[:n, :d]))

    def loss_s(xx, ww):
        return jnp.sum(jnp.cos(sg.spmm_weighted(xx, ww)))

    gd_x, gd_w = jax.jit(jax.grad(loss_d, argnums=(0, 1)))(xs, ws)
    gs_x, gs_w = jax.grad(loss_s, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(np.asarray(gd_x)[:n, :d], gs_x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        dg.gather_edge_vector(gd_w), gs_w, rtol=1e-4, atol=1e-4
    )


def test_split_fused_agnn_fwd_and_grads_exact(mesh42):
    """Fused tile-space AGNN over the split stream (symmetric hub graph):
    guest score tiles use the owner's window rows from the halo; fwd and
    both grads (dx, d attention) must match the single-device fused op."""
    n, d = 400, 16
    ptr, cols = mega_csr(n, symmetric=True, seed=11)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    sp = dg.host_fwd.split
    assert sp is not None and "xa_fetch" in sp and dg._ag_split
    assert dg.agnn_aggregate is not None
    sg = TiledGraph(ptr, cols, n, CFG)
    assert sg.agnn_aggregate is not None
    rng = np.random.default_rng(12)
    x = rng.standard_normal((n, d)).astype(np.float32)
    att = rng.standard_normal((1, 2)).astype(np.float32)
    xs = dg.shard_features(x)

    out_d = jax.jit(dg.agnn_aggregate)(xs, jnp.asarray(att))
    out_s = np.asarray(sg.agnn_aggregate(jnp.asarray(x), jnp.asarray(att)))
    np.testing.assert_allclose(
        np.asarray(out_d)[:n, :d], out_s, rtol=1e-4, atol=1e-4
    )

    def loss_d(xx, aa):
        return jnp.sum(jnp.sin(dg.agnn_aggregate(xx, aa)[:n, :d]))

    def loss_s(xx, aa):
        return jnp.sum(jnp.sin(sg.agnn_aggregate(xx, aa)))

    gd_x, gd_a = jax.jit(jax.grad(loss_d, argnums=(0, 1)))(xs, jnp.asarray(att))
    gs_x, gs_a = jax.grad(loss_s, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(att))
    np.testing.assert_allclose(
        np.asarray(gd_x)[:n, :d], np.asarray(gs_x), rtol=1e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(gd_a), np.asarray(gs_a), rtol=1e-3, atol=1e-3
    )


def test_split_agnn_train_step_decreases_loss(mesh42):
    n = 400
    ptr, cols = mega_csr(n, symmetric=True, seed=14)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    assert dg._ag_split
    rng = np.random.default_rng(0)
    x = dg.shard_features(rng.standard_normal((n, 32)).astype(np.float32))
    y = dg.shard_nodes(rng.integers(0, 5, n).astype(np.int32))
    params, _, _ = init_distributed_net(
        jax.random.PRNGKey(0), "agnn", x.shape[1], 16, 5, 2, dg
    )
    opt = optax.adam(0.01)
    st = opt.init(params)
    step = make_distributed_train_step(
        dg, "agnn", x, y, opt, 0.0, num_valid_classes=5
    )
    key = jax.random.PRNGKey(1)
    losses = []
    for _ in range(5):
        params, st, key, loss = step(params, st, key)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_split_weighted_spmm_directed(mesh42):
    """Directed mega graph: fwd and transpose partitions split independently
    (possibly only one side engages); weighted fwd + dx stay exact."""
    n, d = 400, 16
    ptr, cols = mega_csr(n, seed=7)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    assert dg.host_fwd.split is not None
    sg = TiledGraph(ptr, cols, n, CFG)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(dg.num_edges).astype(np.float32)
    xs = dg.shard_features(x)
    ws = dg.edge_weights_to_sharded(w)
    out = jax.jit(dg.spmm_weighted)(xs, ws)
    want = np.asarray(
        spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols), jnp.asarray(w))
    )
    np.testing.assert_allclose(np.asarray(out)[:n, :d], want, rtol=1e-4, atol=1e-4)
    gd = jax.jit(jax.grad(lambda xx: jnp.sum(dg.spmm_weighted(xx, ws) ** 2)))(xs)
    gs = jax.grad(lambda xx: jnp.sum(sg.spmm_weighted(xx, jnp.asarray(w)) ** 2))(
        jnp.asarray(x)
    )
    np.testing.assert_allclose(
        np.asarray(gd)[:n, :d], np.asarray(gs), rtol=1e-3, atol=1e-3
    )


def test_split_sfused_agnn_pf1_exact():
    """pf==1 split stream rides the score-fused AGNN (score-fused ops);
    fwd and grads match the single-device fused op exactly."""
    from tcgnn.parallel import make_mesh

    mesh81 = make_mesh(n_graph=8, n_feature=1)
    n, d = 400, 16
    ptr, cols = mega_csr(n, symmetric=True, seed=11)
    dg = DistributedTiledGraph(ptr, cols, n, mesh81, CFG)
    assert dg.host_fwd.split is not None and dg._ag_split
    sg = TiledGraph(ptr, cols, n, CFG)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((n, d)).astype(np.float32)
    att = rng.standard_normal((1, 2)).astype(np.float32)
    xs = dg.shard_features(x)

    out_d = jax.jit(dg.agnn_aggregate)(xs, jnp.asarray(att))
    out_s = np.asarray(sg.agnn_aggregate(jnp.asarray(x), jnp.asarray(att)))
    np.testing.assert_allclose(
        np.asarray(out_d)[:n, :d], out_s, rtol=1e-4, atol=1e-4
    )

    def loss_d(xx, aa):
        return jnp.sum(jnp.sin(dg.agnn_aggregate(xx, aa)[:n, :d]))

    def loss_s(xx, aa):
        return jnp.sum(jnp.sin(sg.agnn_aggregate(xx, aa)))

    gd_x, gd_a = jax.jit(jax.grad(loss_d, argnums=(0, 1)))(xs, jnp.asarray(att))
    gs_x, gs_a = jax.grad(loss_s, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(att))
    np.testing.assert_allclose(
        np.asarray(gd_x)[:n, :d], np.asarray(gs_x), rtol=1e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(gd_a), np.asarray(gs_a), rtol=1e-3, atol=1e-3
    )
