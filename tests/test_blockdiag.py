"""Block-diagonal SpMM path: extraction, gating, oracle + grad parity.

The bd path (sgt/blockdiag.py + ops/spmm.py:spmm_block_diag) serves
banded/component graphs as uniform batched matmuls; these tests pin its
semantics against the dense oracle and check the auto-gate keeps power-law
graphs on the condensed design.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import component_union_graph, powerlaw_graph
from tcgnn.graph import TiledGraph
from tcgnn.sgt.blockdiag import bd_coverage, extract_block_diag

CFG = TileConfig(blk_h=128, blk_w=128, edge_chunk=64)


def union_csr(n=1200, e=2600, num_graphs=40, seed=0):
    src, dst = component_union_graph(n, e, num_graphs, seed=seed)
    return coo_to_csr(src, dst, n)


def dense_adj(ptr, idx, n):
    a = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), np.diff(ptr))
    np.add.at(a, (rows, np.asarray(idx)), 1.0)
    return a


def test_extract_roundtrip_exact():
    """Diagonal tiles + residual CSR reassemble the exact adjacency."""
    n = 700
    ptr, idx = union_csr(n=n, e=1500, num_graphs=12, seed=1)
    m = extract_block_diag(ptr, idx, n, bin_rows=128, min_coverage=0.0)
    assert m is not None
    a = np.zeros((n, n), np.float32)
    bn, nb = m.bin_rows, m.num_bins
    tiles = m.dense_tiles()
    for k_i, k in enumerate(m.offsets):
        for b in range(nb):
            r0, c0 = b * bn, (b + k) * bn
            if c0 < 0:
                continue
            t = tiles[k_i, b]
            h = min(bn, n - r0)
            w = min(bn, n - c0) if c0 < n else 0
            if h > 0 and w > 0:
                a[r0 : r0 + h, c0 : c0 + w] += t[:h, :w]
    if m.res_ptr is not None:
        rows = np.repeat(np.arange(n), np.diff(m.res_ptr))
        np.add.at(a, (rows, m.res_idx), 1.0)
    np.testing.assert_array_equal(a, dense_adj(ptr, idx, n))


def test_component_graph_fully_covered():
    """Components <= 128 nodes with contiguous ids need no residual."""
    ptr, idx = union_csr(n=1500, e=3200, num_graphs=60, seed=2)
    assert bd_coverage(ptr, idx) == 1.0
    m = extract_block_diag(ptr, idx, 1500)
    assert m is not None and m.res_ptr is None and m.coverage == 1.0


def test_gate_rejects_powerlaw():
    src, dst = powerlaw_graph(2000, 8000, seed=3)
    ptr, idx = coo_to_csr(src, dst, 2000)
    assert extract_block_diag(ptr, idx, 2000) is None
    g = TiledGraph(ptr, idx, 2000, CFG)
    assert not g.block_diag


def test_tiledgraph_bd_spmm_matches_oracle():
    n = 1800
    ptr, idx = union_csr(n=n, e=3800, num_graphs=50, seed=4)
    g = TiledGraph(ptr, idx, n, CFG)
    assert g.block_diag
    a = dense_adj(ptr, idx, n)
    x = np.random.default_rng(0).standard_normal((n, 9)).astype(np.float32)
    y = np.asarray(g.spmm(jnp.asarray(x)))
    np.testing.assert_allclose(y, a @ x, rtol=1e-5, atol=1e-4)


def test_tiledgraph_bd_grad_matches_transpose():
    n = 900
    ptr, idx = union_csr(n=n, e=2000, num_graphs=25, seed=5)
    g = TiledGraph(ptr, idx, n, CFG)
    assert g.block_diag
    a = dense_adj(ptr, idx, n)
    x = np.random.default_rng(1).standard_normal((n, 5)).astype(np.float32)
    dy = np.random.default_rng(2).standard_normal((n, 5)).astype(np.float32)
    _, vjp = jax.vjp(g.spmm, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(np.asarray(dx), a.T @ dy, rtol=1e-5, atol=1e-4)


def test_bd_with_residual_matches_oracle():
    """A banded graph plus a few long-range edges: residual path adds in."""
    rng = np.random.default_rng(6)
    n = 1600
    ptr, idx = union_csr(n=n, e=3400, num_graphs=45, seed=6)
    # splice in 3% long-range edges
    e_extra = int(0.03 * len(idx))
    src = rng.integers(0, n, e_extra)
    dst = (src + n // 2) % n
    rows = np.repeat(np.arange(n), np.diff(ptr))
    all_src = np.concatenate([rows, src, dst])
    all_dst = np.concatenate([np.asarray(idx), dst, src])
    ptr2, idx2 = coo_to_csr(all_src, all_dst, n)
    g = TiledGraph(ptr2, idx2, n, CFG)
    assert g.block_diag  # coverage ~0.97 passes the gate
    a = dense_adj(ptr2, idx2, n)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.asarray(g.spmm(jnp.asarray(x)))
    np.testing.assert_allclose(y, a @ x, rtol=1e-5, atol=1e-4)
    # gradient crosses both classes too
    _, vjp = jax.vjp(g.spmm, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(dx), a.T @ x, rtol=1e-5, atol=1e-4)


def test_bind_arrays_roundtrip_with_bd():
    """The jit-boundary pytree carries the bd arrays (HTTP 413 contract)."""
    n = 1000
    ptr, idx = union_csr(n=n, e=2200, num_graphs=30, seed=7)
    g = TiledGraph(ptr, idx, n, CFG)
    assert g.block_diag
    x = np.random.default_rng(3).standard_normal((n, 4)).astype(np.float32)

    @jax.jit
    def step(arrays, xj):
        return g.bind(arrays).spmm(xj)

    y = np.asarray(step(g.arrays(), jnp.asarray(x)))
    np.testing.assert_allclose(
        y, dense_adj(ptr, idx, n) @ x, rtol=1e-5, atol=1e-4
    )


def test_component_union_generator_shape_contract():
    src, dst = component_union_graph(5000, 11000, 150, seed=8)
    ptr, idx = coo_to_csr(src, dst, 5000)
    assert len(ptr) == 5001
    e = len(idx)
    assert abs(e - 11000) / 11000 < 0.06  # dedup/symmetrize keeps scale
    # symmetric by construction
    a = dense_adj(ptr, idx, 5000)
    np.testing.assert_array_equal(a, a.T)
    # every node has degree >= 1 (spanning paths)
    assert (np.diff(ptr) > 0).all()


# ---------------------------------------------------------------------------
# Weighted SpMM / SDDMM / fused attention in BD tile space
# ---------------------------------------------------------------------------
def _dense_weighted(ptr, idx, n, w):
    rows = np.repeat(np.arange(n), np.diff(ptr))
    a = np.zeros((n, n), np.float32)
    np.add.at(a, (rows, np.asarray(idx)), np.asarray(w))
    return a


def test_bd_weighted_spmm_and_sddmm_match_oracle():
    n = 1200
    ptr, idx = union_csr(n=n, e=2600, num_graphs=40, seed=10)
    g = TiledGraph(ptr, idx, n, CFG)
    assert g.block_diag and g._bd_full_coverage
    rng = np.random.default_rng(10)
    x = jnp.asarray(rng.standard_normal((n, 24)).astype(np.float32))
    w = jnp.asarray(rng.random(g.num_edges).astype(np.float32))
    aw = _dense_weighted(ptr, idx, n, w)
    np.testing.assert_allclose(
        np.asarray(g.spmm_weighted(x, w)), aw @ np.asarray(x),
        rtol=2e-4, atol=2e-4,
    )
    rows = np.repeat(np.arange(n), np.diff(ptr))
    xo = np.asarray(x)
    want = (xo[rows] * xo[np.asarray(idx)]).sum(1)
    np.testing.assert_allclose(
        np.asarray(g.sddmm(x)), want, rtol=2e-4, atol=2e-4
    )


def test_bd_weighted_residual_directed_grads():
    """Banded + long-range directed graph: weighted ops cross the BD pack
    AND the residual condensed path; dx/dw exact vs the dense oracle."""
    rng = np.random.default_rng(11)
    n = 1500
    src_b = rng.integers(0, n, 4000)
    dst_b = np.clip(src_b + rng.integers(-100, 101, 4000), 0, n - 1)
    src_r = rng.integers(0, n, 400)
    dst_r = rng.integers(0, n, 400)
    ptr, idx = coo_to_csr(
        np.concatenate([src_b, src_r]), np.concatenate([dst_b, dst_r]), n
    )
    g = TiledGraph(ptr, idx, n, CFG)
    assert g.block_diag and not g._bd_full_coverage and not g.symmetric
    rows = np.repeat(np.arange(n), np.diff(ptr))
    x = jnp.asarray(rng.standard_normal((n, 16)).astype(np.float32))
    w = jnp.asarray(rng.random(g.num_edges).astype(np.float32))
    aw = _dense_weighted(ptr, idx, n, w)
    np.testing.assert_allclose(
        np.asarray(g.spmm_weighted(x, w)), aw @ np.asarray(x),
        rtol=2e-4, atol=2e-4,
    )
    xo = np.asarray(x)
    want_e = (xo[rows] * xo[np.asarray(idx)]).sum(1)
    np.testing.assert_allclose(
        np.asarray(g.sddmm(x)), want_e, rtol=2e-4, atol=2e-4
    )

    def loss(x_, w_):
        return jnp.sum(jnp.cos(g.spmm_weighted(x_, w_)))

    gx, gw = jax.grad(loss, argnums=(0, 1))(x, w)
    ridx = jnp.asarray(rows), jnp.asarray(np.asarray(idx))

    def loss_o(x_, w_):
        aw_ = jnp.zeros((n, n)).at[ridx].add(w_)
        return jnp.sum(jnp.cos(aw_ @ x_))

    ogx, ogw = jax.grad(loss_o, argnums=(0, 1))(x, w)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(ogx), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(gw), np.asarray(ogw), rtol=2e-3, atol=2e-3)


def test_bd_fused_agnn_matches_dense_formulation():
    """Full-coverage symmetric BD graph: the packed-diagonal fused AGNN path
    (value and grads) equals the dense ``mean(c) * (A ⊙ XX^T) X``."""
    n = 1100
    ptr, idx = union_csr(n=n, e=2400, num_graphs=35, seed=12)
    g = TiledGraph(ptr, idx, n, CFG)
    assert g.block_diag and g._bd_full_coverage and g.symmetric
    assert g.agnn_aggregate is not None
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.standard_normal((n, 12)).astype(np.float32))
    att_w = jnp.asarray(rng.random((1, 1)).astype(np.float32))
    a = jnp.asarray(dense_adj(ptr, idx, n))

    y = g.agnn_aggregate(x, att_w)
    want = jnp.mean(att_w) * ((a * (x @ x.T)) @ x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(want), rtol=2e-3, atol=2e-3)

    def loss(x_, aw_):
        return jnp.sum(jnp.sin(g.agnn_aggregate(x_, aw_)))

    def loss_o(x_, aw_):
        return jnp.sum(jnp.sin(jnp.mean(aw_) * ((a * (x_ @ x_.T)) @ x_)))

    gx, gaw = jax.grad(loss, argnums=(0, 1))(x, att_w)
    ogx, ogaw = jax.grad(loss_o, argnums=(0, 1))(x, att_w)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(ogx), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(gaw), np.asarray(ogaw), rtol=2e-3, atol=2e-3)


def test_bd_one_signed_offsets_upper_triangular():
    """A strictly upper-triangular banded graph selects only positive
    offsets (no diagonal-0 stream); pads/slices must stay in-bounds and
    values + grads must match the dense oracle."""
    n = 1024
    rng = np.random.default_rng(21)
    src = rng.integers(0, n - 256, 3000)
    dst = src + rng.integers(128, 256, 3000)  # offsets {+1, +2} only
    ptr, idx = coo_to_csr(src, dst, n)
    g = TiledGraph(ptr, idx, n, CFG)
    assert g.block_diag and min(g._bd_offsets) > 0, g._bd_offsets
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    a = dense_adj(ptr, idx, n)
    np.testing.assert_allclose(
        np.asarray(g.spmm(x)), a @ np.asarray(x), rtol=2e-4, atol=2e-4
    )

    def loss(x_):
        return jnp.sum(jnp.cos(g.spmm(x_)))

    gx = jax.grad(loss)(x)
    ogx = jax.grad(lambda x_: jnp.sum(jnp.cos(jnp.asarray(a) @ x_)))(x)
    np.testing.assert_allclose(
        np.asarray(gx), np.asarray(ogx), rtol=2e-3, atol=2e-3
    )
    # weighted + sddmm ride the same stack/transpose helpers
    w = jnp.asarray(rng.random(g.num_edges).astype(np.float32))
    aw = _dense_weighted(ptr, idx, n, w)
    np.testing.assert_allclose(
        np.asarray(g.spmm_weighted(x, w)), aw @ np.asarray(x),
        rtol=2e-4, atol=2e-4,
    )
    rows = np.repeat(np.arange(n), np.diff(ptr))
    xo = np.asarray(x)
    np.testing.assert_allclose(
        np.asarray(g.sddmm(x)), (xo[rows] * xo[np.asarray(idx)]).sum(1),
        rtol=2e-4, atol=2e-4,
    )


def test_bd_full_coverage_skips_condensed_tiles():
    """Fully-covered BD graphs must not build the dead condensed tile array."""
    n = 1200
    ptr, idx = union_csr(n=n, e=2600, num_graphs=40, seed=13)
    g = TiledGraph(ptr, idx, n, CFG)
    assert g.block_diag and g._bd_full_coverage
    _, _, a_struct, a_struct_t, *_ = g._device_arrays
    assert a_struct is None and a_struct_t is None
