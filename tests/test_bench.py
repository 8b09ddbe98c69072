"""Benchmark-harness units: tile counters, log scraper, XLA baseline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.bench.log2csv import scrape
from tcgnn.bench.tc_block_count import count_tiles
from tcgnn.bench.baseline import XlaBaselineGraph
from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph
from tcgnn.graph import TiledGraph
from tcgnn.sgt import native


def make_graph(n, e, seed=0):
    src, dst = powerlaw_graph(n, e, seed=seed)
    return coo_to_csr(src, dst, n)


def spec_counts(ptr, cols, blk_h, blk_w):
    """Direct port of 3_cnt_TC_blk_SpMM.py:55-84 per-window logic."""
    n = len(ptr) - 1
    naive = opt = 0
    for start in range(0, n, blk_h):
        end = min(start + blk_h, n)
        uniq = sorted(set(cols[ptr[start] : ptr[end]].tolist()))
        opt += -(-len(uniq) // blk_w)
        i = j = 0
        while i < len(uniq) and j < len(uniq):
            cap = uniq[i] + blk_w
            while j < len(uniq) and uniq[j] < cap:
                j += 1
            i = j
            naive += 1
    return naive, opt


@pytest.mark.parametrize("blk", [(16, 8), (16, 16), (128, 128)])
def test_count_tiles_matches_reference_spec(blk):
    ptr, cols = make_graph(500, 3000, seed=1)
    got = count_tiles(ptr, cols, *blk)
    want = spec_counts(ptr, cols, *blk)
    assert got == want


def test_naive_never_below_opt():
    ptr, cols = make_graph(300, 2500, seed=9)
    naive, opt = count_tiles(ptr, cols, 16, 8)
    assert naive >= opt  # reference's "Duplicate Edges" guard invariant


def test_log2csv_scrape():
    log = [
        "Namespace(dataset='cora', dim=1433)",
        "Prep. (ms):\t12.3",
        "Train (ms):\t 3.141",
        "Namespace(dataset='pubmed', dim=500)",
        "Train (ms):\t 2.718",
    ]
    assert scrape(log) == [("cora", 3.141), ("pubmed", 2.718)]


def test_xla_baseline_matches_tcgnn_forward():
    n, d = 200, 24
    ptr, cols = make_graph(n, 1200, seed=4)
    cfg = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)
    tg = TiledGraph(ptr, cols, n, cfg)
    bg = XlaBaselineGraph(ptr, cols, n)
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(tg.spmm(x)), np.asarray(bg.spmm(x)), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(tg.sddmm(x)), np.asarray(bg.sddmm(x)), rtol=1e-4, atol=1e-4
    )
    w = jax.random.normal(jax.random.PRNGKey(1), (tg.num_edges,), jnp.float32)
    gt = jax.grad(lambda xx: jnp.sum(jnp.sin(tg.spmm_weighted(xx, w))))(x)
    gb = jax.grad(lambda xx: jnp.sum(jnp.sin(bg.spmm_weighted(xx, w))))(x)
    np.testing.assert_allclose(np.asarray(gt), np.asarray(gb), rtol=1e-4, atol=1e-4)


def test_native_naive_count_available():
    if not native.available():
        pytest.skip("native lib unavailable")
    ptr, cols = make_graph(400, 2000, seed=2)
    out = native.naive_count(
        np.ascontiguousarray(ptr, np.int64),
        np.ascontiguousarray(cols, np.int32),
        16, 8,
    )
    assert out.sum() == spec_counts(ptr, cols, 16, 8)[0]
