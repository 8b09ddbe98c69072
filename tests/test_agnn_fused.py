"""Fused tile-space AGNN aggregation vs the per-edge reference path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph
from tcgnn.graph import TiledGraph
from tcgnn.models import layers as L

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)


@pytest.fixture(scope="module")
def graphs():
    n = 180
    src, dst = powerlaw_graph(n, 1100, seed=7)  # symmetrized generator
    ptr, cols = coo_to_csr(src, dst, n)
    g_fused = TiledGraph(ptr, cols, n, CFG)
    assert g_fused.symmetric and g_fused.agnn_aggregate is not None
    g_ref = TiledGraph(ptr, cols, n, CFG, dense_tiles=False)
    assert g_ref.agnn_aggregate is None  # falls back to per-edge path
    return g_fused, g_ref, n


def test_fused_agnn_matches_per_edge_path(graphs):
    g_fused, g_ref, n = graphs
    d = 12
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    params = L.init_agnn(jax.random.PRNGKey(1), d, 8, n_heads=2)
    out_f = L.agnn_conv(params, x, g_fused)
    out_r = L.agnn_conv(params, x, g_ref)
    np.testing.assert_allclose(
        np.asarray(out_f), np.asarray(out_r), rtol=1e-4, atol=1e-4
    )


def test_fused_agnn_grads_match(graphs):
    g_fused, g_ref, n = graphs
    d = 10
    x = jax.random.normal(jax.random.PRNGKey(2), (n, d), jnp.float32)
    params = L.init_agnn(jax.random.PRNGKey(3), d, 6, n_heads=1)

    def loss(g):
        def f(p, xx):
            return jnp.sum(jnp.tanh(L.agnn_conv(p, xx, g) * 0.1))
        return f

    gf_p, gf_x = jax.grad(loss(g_fused), argnums=(0, 1))(params, x)
    gr_p, gr_x = jax.grad(loss(g_ref), argnums=(0, 1))(params, x)
    np.testing.assert_allclose(np.asarray(gf_x), np.asarray(gr_x), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(gf_p["weights"]), np.asarray(gr_p["weights"]), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(gf_p["attention_w"]),
        np.asarray(gr_p["attention_w"]),
        rtol=1e-3,
        atol=1e-4,
    )


def test_fused_agnn_numeric_grad(graphs):
    """Finite-difference check of the custom VJP itself."""
    g_fused, _, n = graphs
    d = 8
    x = jax.random.normal(jax.random.PRNGKey(4), (n, d), jnp.float32) * 0.3
    att = jnp.asarray([[0.7]])

    def f(xx, aa):
        return jnp.sum(jnp.sin(g_fused.agnn_aggregate(xx, aa)))

    gx = np.asarray(jax.grad(f, argnums=0)(x, att))
    ga = float(jax.grad(f, argnums=1)(x, att)[0, 0])

    eps = 1e-3
    for idx in [(0, 0), (n // 2, d - 1), (n - 1, 3)]:
        xp = x.at[idx].add(eps)
        xm = x.at[idx].add(-eps)
        num = (float(f(xp, att)) - float(f(xm, att))) / (2 * eps)
        np.testing.assert_allclose(gx[idx], num, rtol=2e-2, atol=2e-3)
    num_a = (float(f(x, att + eps)) - float(f(x, att - eps))) / (2 * eps)
    np.testing.assert_allclose(ga, num_a, rtol=2e-2, atol=2e-3)


def _banded_graph(n, halfband, n_residual, seed=0):
    """Symmetric banded graph + sparse symmetric long-range residual edges."""
    rng = np.random.default_rng(seed)
    src_l, dst_l = [], []
    for i in range(n):
        nbrs = i + rng.integers(1, halfband, size=6)
        nbrs = nbrs[nbrs < n]
        src_l.append(np.full(len(nbrs), i))
        dst_l.append(nbrs)
    a = rng.integers(0, n // 2, n_residual)
    b = a + n // 2 + rng.integers(0, n // 2 - 1, n_residual) % (n - 1 - a - n // 2 + 1)
    src_l.append(a)
    dst_l.append(np.minimum(b, n - 1))
    s = np.concatenate(src_l)
    d = np.concatenate(dst_l)
    keep = s != d
    s, d = s[keep], d[keep]
    return coo_to_csr(np.concatenate([s, d]), np.concatenate([d, s]), n)


def test_bd_partial_coverage_composite_agnn():
    """BD + symmetric residual rides the composite score-fused path (the
    DD-class case: coverage < 1 with sign-symmetric offsets)."""
    n = 1500
    ptr, cols = _banded_graph(n, halfband=40, n_residual=60, seed=3)
    g = TiledGraph(ptr, cols, n, TileConfig(blk_h=128, blk_w=128))
    assert g.symmetric and g.block_diag
    assert not g._bd_full_coverage  # the residual edges exist
    assert g.agnn_aggregate is not None
    g_ref = TiledGraph(
        ptr, cols, n, TileConfig(blk_h=128, blk_w=128), dense_tiles=False
    )
    assert g_ref.agnn_aggregate is None

    d = 12
    x = jax.random.normal(jax.random.PRNGKey(5), (n, d), jnp.float32) * 0.2
    params = L.init_agnn(jax.random.PRNGKey(6), d, 8)
    out_f = L.agnn_conv(params, x, g)
    out_r = L.agnn_conv(params, x, g_ref)
    np.testing.assert_allclose(
        np.asarray(out_f), np.asarray(out_r), rtol=1e-4, atol=1e-4
    )

    def loss(gg):
        def f(p, xx):
            return jnp.sum(jnp.tanh(L.agnn_conv(p, xx, gg) * 0.1))
        return f

    gf_p, gf_x = jax.grad(loss(g), argnums=(0, 1))(params, x)
    gr_p, gr_x = jax.grad(loss(g_ref), argnums=(0, 1))(params, x)
    np.testing.assert_allclose(np.asarray(gf_x), np.asarray(gr_x), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(gf_p["attention_w"]), np.asarray(gr_p["attention_w"]),
        rtol=1e-3, atol=1e-4,
    )


def test_bd_offset_beyond_halo_falls_back_to_per_edge():
    """Full-coverage BD whose offsets lie far from the diagonal (beyond any
    fixed halo) rides the fused BD AGNN and matches the per-edge path."""
    n = 4000  # ~32 bins of 128
    ring = np.arange(n - 1)
    far = np.arange(n - 1300)
    src = np.concatenate([ring, ring + 1, far, far + 1300])
    dst = np.concatenate([ring + 1, ring, far + 1300, far])
    ptr, cols = coo_to_csr(src, dst, n)
    g = TiledGraph(ptr, cols, n, TileConfig(blk_h=128, blk_w=128))
    assert g.symmetric
    if not g.block_diag:
        pytest.skip("BD gate rejected the construction")
    assert max(abs(o) for o in g._bd_offsets) > 8
    assert g.agnn_aggregate is not None  # any offset set rides the fused op
    # It agrees with the per-edge path.
    g_ref = TiledGraph(
        ptr, cols, n, TileConfig(blk_h=128, blk_w=128), dense_tiles=False
    )
    d = 6
    x = jax.random.normal(jax.random.PRNGKey(7), (n, d), jnp.float32) * 0.2
    params = L.init_agnn(jax.random.PRNGKey(8), d, 4)
    np.testing.assert_allclose(
        np.asarray(L.agnn_conv(params, x, g)),
        np.asarray(L.agnn_conv(params, x, g_ref)),
        rtol=1e-4, atol=1e-4,
    )


def test_directed_graph_has_no_fused_path():
    n = 100
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, 400)
    dst = (src + 1 + rng.integers(0, n - 1, 400)) % n
    ptr, cols = coo_to_csr(src, dst, n)
    g = TiledGraph(ptr, cols, n, CFG)
    assert not g.symmetric and g.agnn_aggregate is None


def test_sfused_wide_feature_dim_matches_fallback():
    """Score-fused kernels at d > 128 (lane-tiled padding): fwd + grads
    match the per-edge path on a power-law graph."""
    n, d = 300, 150
    rng = np.random.default_rng(9)
    src = rng.integers(0, n, 2600)
    dst = rng.integers(0, n, 2600)
    keep = src != dst
    ptr, cols = coo_to_csr(
        np.concatenate([src[keep], dst[keep]]),
        np.concatenate([dst[keep], src[keep]]), n,
    )
    cfg = TileConfig(blk_h=64, blk_w=64, edge_chunk=64)
    g = TiledGraph(ptr, cols, n, cfg)
    assert g.symmetric and g.agnn_aggregate is not None
    g_ref = TiledGraph(ptr, cols, n, cfg, dense_tiles=False)
    assert g_ref.agnn_aggregate is None

    x = jax.random.normal(jax.random.PRNGKey(2), (n, d), jnp.float32) * 0.1
    att = jnp.asarray([[0.7, -0.3]], jnp.float32)
    np.testing.assert_allclose(
        np.asarray(g.agnn_aggregate(x, att)),
        np.asarray(
            jnp.mean(att)
            * g_ref.spmm_weighted(x, g_ref.sddmm(x))
        ),
        rtol=1e-3, atol=1e-3,
    )

    def loss(gg):
        if gg.agnn_aggregate is not None:
            return lambda xx, aa: jnp.sum(
                jnp.tanh(gg.agnn_aggregate(xx, aa) * 0.1)
            )
        return lambda xx, aa: jnp.sum(
            jnp.tanh(jnp.mean(aa) * gg.spmm_weighted(xx, gg.sddmm(xx)) * 0.1)
        )

    gx_f, ga_f = jax.grad(loss(g), argnums=(0, 1))(x, att)
    gx_r, ga_r = jax.grad(loss(g_ref), argnums=(0, 1))(x, att)
    np.testing.assert_allclose(np.asarray(gx_f), np.asarray(gx_r), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(ga_f), np.asarray(ga_r), rtol=2e-3, atol=2e-3)
