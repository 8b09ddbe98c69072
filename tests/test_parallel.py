"""Distributed (shard_map) ops vs single-device oracle on an 8-CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tcgnn.config import TileConfig
from tcgnn.graph import TiledGraph
from tcgnn.ops.reference import spmm_ref, sddmm_ref
from tcgnn.parallel import (
    DistributedTiledGraph,
    make_mesh,
    make_distributed_train_step,
    init_distributed_net,
)
from tcgnn.models import nets

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)


def random_csr(n, avg_deg, seed=0):
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_deg, n).clip(0, n - 1)
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    return ptr.astype(np.int32), np.concatenate(cols).astype(np.int32)


@pytest.fixture(scope="module")
def mesh42():
    return make_mesh(n_graph=4, n_feature=2)


@pytest.fixture(scope="module")
def setup(mesh42):
    n, d = 150, 48
    ptr, cols = random_csr(n, avg_deg=6, seed=3)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    sg = TiledGraph(ptr, cols, n, CFG)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return dg, sg, x, None, ptr, cols


def _crop(dg, out, n, d):
    return np.asarray(out)[:n, :d]


def test_dspmm_matches_dense(setup):
    dg, sg, x, a, ptr, cols = setup
    n, d = x.shape
    xs = dg.shard_features(x)
    out = jax.jit(dg.spmm)(xs)
    want = np.asarray(spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols)))
    np.testing.assert_allclose(_crop(dg, out, n, d), want, rtol=1e-5, atol=1e-5)


def test_dspmm_weighted_matches_dense(setup):
    dg, sg, x, a, ptr, cols = setup
    n, d = x.shape
    rng = np.random.default_rng(1)
    w = rng.standard_normal(dg.num_edges).astype(np.float32)
    ws = dg.edge_weights_to_sharded(w)
    xs = dg.shard_features(x)
    out = jax.jit(dg.spmm_weighted)(xs, ws)
    want = np.asarray(
        spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols), jnp.asarray(w))
    )
    np.testing.assert_allclose(_crop(dg, out, n, d), want, rtol=1e-4, atol=1e-4)


def test_dsddmm_matches_dense(setup):
    dg, sg, x, a, ptr, cols = setup
    n, d = x.shape
    xs = dg.shard_features(x)
    scores = jax.jit(dg.sddmm)(xs)
    got = dg.gather_edge_vector(scores)
    deg = np.diff(ptr)
    rows = np.repeat(np.arange(n), deg)
    want = np.einsum("ed,ed->e", x[rows], x[cols])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dspmm_grad_matches_single_device(setup):
    dg, sg, x, a, ptr, cols = setup
    n, d = x.shape
    xs = dg.shard_features(x)

    def loss_d(xx):
        return jnp.sum(jnp.sin(dg.spmm(xx)[:n, :d]))

    def loss_s(xx):
        return jnp.sum(jnp.sin(sg.spmm(xx)))

    gd = np.asarray(jax.jit(jax.grad(loss_d))(xs))[:n, :d]
    gs = np.asarray(jax.grad(loss_s)(jnp.asarray(x)))
    np.testing.assert_allclose(gd, gs, rtol=1e-4, atol=1e-4)


def test_dspmm_weighted_grads(setup):
    dg, sg, x, a, ptr, cols = setup
    n, d = x.shape
    rng = np.random.default_rng(5)
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


def test_dsddmm_grad_matches_single_device(setup):
    dg, sg, x, a, ptr, cols = setup
    n, d = x.shape
    xs = dg.shard_features(x)

    # weight the edge scores so the grad isn't symmetric-trivial
    wvec = np.arange(dg.num_edges, dtype=np.float32) % 7 - 3

    ws = dg.edge_weights_to_sharded(wvec)
    wj = jnp.asarray(wvec)

    def loss_d(xx):
        return jnp.sum(dg.sddmm(xx) * ws)

    def loss_s(xx):
        return jnp.sum(sg.sddmm(xx) * wj)

    gd = np.asarray(jax.jit(jax.grad(loss_d))(xs))[:n, :d]
    gs = np.asarray(jax.grad(loss_s)(jnp.asarray(x)))
    np.testing.assert_allclose(gd, gs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["gcn", "gin", "agnn"])
def test_distributed_train_step_runs_and_improves(setup, kind):
    dg, sg, x, a, ptr, cols = setup
    n, d = x.shape
    classes = 5
    y = np.arange(n) % classes

    key = jax.random.PRNGKey(0)
    params, hidden_p, classes_p = init_distributed_net(
        key, kind, dg.shard_features(x).shape[1], 8, classes, 2, dg
    )
    xs = dg.shard_features(x)
    ys = dg.shard_nodes(y.astype(np.int32))
    opt = optax.adam(0.01)
    step = make_distributed_train_step(
        dg, kind, xs, ys, opt, dropout_rate=0.0, num_valid_classes=classes
    )
    state = opt.init(params)
    losses = []
    k = jax.random.PRNGKey(1)
    for _ in range(5):
        params, state, k, loss = step(params, state, k)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_distributed_loss_matches_single_device(setup):
    """Same init, same graph: distributed masked loss == single-device loss."""
    dg, sg, x, a, ptr, cols = setup
    n, d = x.shape
    classes = 4
    y = (np.arange(n) * 7) % classes

    d_in = dg.shard_features(x).shape[1]
    key = jax.random.PRNGKey(42)
    params = nets.init_net(key, "gcn", d_in, 8, classes, 2)

    xs = dg.shard_features(x)
    ys = dg.shard_nodes(y.astype(np.int32))
    mask = dg.valid_node_mask()

    def loss_d(p):
        logp = nets.apply_net(p, "gcn", xs, dg)
        nll = -jnp.take_along_axis(logp, ys[:, None], axis=1)[:, 0]
        return jnp.sum(nll * mask) / n

    # single-device with identically padded input features
    x_pad = np.zeros((n, d_in), np.float32)
    x_pad[:, :d] = x

    def loss_s(p):
        logp = nets.apply_net(p, "gcn", jnp.asarray(x_pad), sg)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1))

    ld = float(jax.jit(loss_d)(params))
    ls = float(loss_s(params))
    assert abs(ld - ls) < 1e-4, (ld, ls)


def test_chunk_fallback_matches_dense(setup, mesh42):
    dg, sg, x, a, ptr, cols = setup
    n, d = x.shape
    dgc = DistributedTiledGraph(ptr, cols, n, mesh42, CFG, dense_tiles=False)
    assert dg.dense_tiles and not dgc.dense_tiles
    xs = dg.shard_features(x)
    out_d = np.asarray(jax.jit(dg.spmm)(xs))[:n, :d]
    out_c = np.asarray(jax.jit(dgc.spmm)(dgc.shard_features(x)))[:n, :d]
    np.testing.assert_allclose(out_d, out_c, rtol=1e-4, atol=1e-4)
    sc_d = dg.gather_edge_vector(jax.jit(dg.sddmm)(xs))
    sc_c = dgc.gather_edge_vector(jax.jit(dgc.sddmm)(dgc.shard_features(x)))
    np.testing.assert_allclose(sc_d, sc_c, rtol=1e-4, atol=1e-4)


def test_overlap_split_is_nontrivial_and_used(setup):
    dg, sg, x, a, ptr, cols = setup
    assert dg._use_overlap
    ov = dg.host_fwd.overlap
    n_local = int((np.asarray(ov["local"]["a_tiles"]) != 0).any(axis=(2, 3)).sum())
    n_remote = int((np.asarray(ov["remote"]["a_tiles"]) != 0).any(axis=(2, 3)).sum())
    # window-aligned contiguous partitioning + local graph structure must
    # yield real blocks in BOTH classes
    assert n_local > 0 and n_remote > 0, (n_local, n_remote)


def test_distributed_fused_agnn_matches_single_device(mesh42):
    from tcgnn.data.synthetic import powerlaw_graph
    from tcgnn.data.dataset import coo_to_csr
    from tcgnn.models import layers as L

    n, d = 160, 16
    src, dst = powerlaw_graph(n, 1000, seed=11)  # symmetric generator
    ptr, cols = coo_to_csr(src, dst, n)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, CFG)
    sg = TiledGraph(ptr, cols, n, CFG)
    assert dg.symmetric and dg.agnn_aggregate is not None
    assert sg.agnn_aggregate is not None

    x = np.random.default_rng(3).standard_normal((n, d)).astype(np.float32)
    xs = dg.shard_features(x)
    d_in = xs.shape[1]
    params = L.init_agnn(jax.random.PRNGKey(5), d_in, 8, n_heads=2)
    x_pad = np.zeros((n, d_in), np.float32)
    x_pad[:, :d] = x

    out_d = L.agnn_conv(params, xs, dg)
    out_s = L.agnn_conv(params, jnp.asarray(x_pad), sg)
    np.testing.assert_allclose(
        np.asarray(out_d)[:n, :8], np.asarray(out_s), rtol=1e-4, atol=1e-4
    )

    # gradients through the distributed fused custom VJP
    def loss_d(p, xx):
        return jnp.sum(jnp.tanh(L.agnn_conv(p, xx, dg)[:n] * 0.1))

    def loss_s(p, xx):
        return jnp.sum(jnp.tanh(L.agnn_conv(p, xx, sg) * 0.1))

    gd = jax.grad(loss_d, argnums=(0, 1))(params, xs)
    gs = jax.grad(loss_s, argnums=(0, 1))(params, jnp.asarray(x_pad))
    np.testing.assert_allclose(
        np.asarray(gd[0]["attention_w"]), np.asarray(gs[0]["attention_w"]),
        rtol=1e-3, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(gd[1])[:n], np.asarray(gs[1]), rtol=1e-3, atol=1e-4
    )


def test_distributed_sfused_agnn_pf1_matches_single_device():
    """pf==1 mesh takes the score-fused distributed AGNN (one-call fused
    backward) — fwd and grads exact vs single
    device."""
    from tcgnn.data.synthetic import powerlaw_graph
    from tcgnn.data.dataset import coo_to_csr
    from tcgnn.models import layers as L
    from tcgnn.parallel import make_mesh

    mesh81 = make_mesh(n_graph=8, n_feature=1)
    n, d = 160, 16
    src, dst = powerlaw_graph(n, 1000, seed=11)
    ptr, cols = coo_to_csr(src, dst, n)
    dg = DistributedTiledGraph(ptr, cols, n, mesh81, CFG)
    sg = TiledGraph(ptr, cols, n, CFG)
    assert dg.symmetric and dg.agnn_aggregate is not None

    x = np.random.default_rng(3).standard_normal((n, d)).astype(np.float32)
    xs = dg.shard_features(x)
    d_in = xs.shape[1]
    params = L.init_agnn(jax.random.PRNGKey(5), d_in, 8, n_heads=2)
    x_pad = np.zeros((n, d_in), np.float32)
    x_pad[:, :d] = x

    out_d = L.agnn_conv(params, xs, dg)
    out_s = L.agnn_conv(params, jnp.asarray(x_pad), sg)
    np.testing.assert_allclose(
        np.asarray(out_d)[:n, :8], np.asarray(out_s), rtol=1e-4, atol=1e-4
    )

    def loss_d(p, xx):
        return jnp.sum(jnp.tanh(L.agnn_conv(p, xx, dg)[:n] * 0.1))

    def loss_s(p, xx):
        return jnp.sum(jnp.tanh(L.agnn_conv(p, xx, sg) * 0.1))

    gd = jax.grad(loss_d, argnums=(0, 1))(params, xs)
    gs = jax.grad(loss_s, argnums=(0, 1))(params, jnp.asarray(x_pad))
    np.testing.assert_allclose(
        np.asarray(gd[0]["attention_w"]), np.asarray(gs[0]["attention_w"]),
        rtol=1e-3, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(gd[1])[:n], np.asarray(gs[1]), rtol=1e-3, atol=1e-4
    )
