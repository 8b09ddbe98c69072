"""Native (C++/OpenMP) SGT pass vs the NumPy reference implementation."""

import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph
from tcgnn.sgt import native
from tcgnn.sgt.translate import (
    build_a_tiles_host,
    count_blocks,
    sparse_graph_translate,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native SGT library unavailable (no g++?)"
)

CFGS = [TileConfig(blk_h=8, blk_w=8, edge_chunk=8), TileConfig()]


def make_graph(n, e, seed=0):
    src, dst = powerlaw_graph(n, e, seed=seed)
    return coo_to_csr(src, dst, n)


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("n,e", [(100, 600), (1000, 8000)])
def test_native_matches_numpy(cfg, n, e):
    indptr, indices = make_graph(n, e, seed=n)
    m_np = sparse_graph_translate(indptr, indices, n, cfg, impl="numpy")
    m_nat = sparse_graph_translate(indptr, indices, n, cfg, impl="native")

    np.testing.assert_array_equal(m_np.block_partition, m_nat.block_partition)
    assert m_np.num_real_blocks == m_nat.num_real_blocks
    np.testing.assert_array_equal(m_np.col_ids, m_nat.col_ids)
    np.testing.assert_array_equal(m_np.edge_pos, m_nat.edge_pos)
    np.testing.assert_array_equal(m_np.block_window, m_nat.block_window)
    np.testing.assert_array_equal(
        m_np.block_first_in_window, m_nat.block_first_in_window
    )
    # chunk layout is derived from identical (block, r, c) — spot-check
    np.testing.assert_array_equal(m_np.chunk_r, m_nat.chunk_r)
    np.testing.assert_array_equal(m_np.edge_perm, m_nat.edge_perm)


@pytest.mark.parametrize("cfg", CFGS)
def test_fused_tiles_match_bincount(cfg):
    indptr, indices = make_graph(500, 3000, seed=7)
    m = sparse_graph_translate(
        indptr, indices, 500, cfg, impl="native", emit_chunks=False, build_tiles=True
    )
    assert m.a_tiles is not None
    ref = np.bincount(
        m.edge_pos, minlength=m.num_blocks * cfg.blk_h * cfg.blk_w
    ).astype(np.float32).reshape(m.num_blocks, cfg.blk_h, cfg.blk_w)
    np.testing.assert_array_equal(m.a_tiles, ref)
    np.testing.assert_array_equal(build_a_tiles_host(m), m.a_tiles)


def test_count_blocks_matches_translate():
    cfg = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)
    indptr, indices = make_graph(700, 4000, seed=11)
    m = sparse_graph_translate(indptr, indices, 700, cfg, impl="numpy")
    assert count_blocks(indptr, indices, 700, cfg) == m.num_blocks


def test_lite_meta_has_no_chunks():
    cfg = TileConfig(blk_h=8, blk_w=8, edge_chunk=8)
    indptr, indices = make_graph(200, 900, seed=3)
    m = sparse_graph_translate(indptr, indices, 200, cfg, emit_chunks=False)
    assert m.chunk_block is None and m.num_chunks == 0
    j = m.as_jax()
    assert j.chunk_r is None and j.col_ids is not None


def test_native_transpose_matches_numpy():
    rng = np.random.default_rng(5)
    n, e = 700, 4000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    ptr, cols = coo_to_csr(src, dst, n)
    from tcgnn.sgt import native

    if not native.available():
        pytest.skip("no native lib")
    t_ptr, t_cols, t_src = native.transpose(ptr, cols, n)
    # numpy reference (the fallback path in transpose_csr)
    degrees = np.diff(np.asarray(ptr, np.int64))
    s = np.repeat(np.arange(n, dtype=np.int64), degrees)
    d = np.asarray(cols, np.int64)
    order = np.argsort(d, kind="stable")
    np.testing.assert_array_equal(t_cols, s[order].astype(np.int32))
    np.testing.assert_array_equal(t_src, order.astype(np.int32))
    want_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(d, minlength=n), out=want_ptr[1:])
    np.testing.assert_array_equal(t_ptr, want_ptr)


def test_native_chunk_layout_matches_numpy():
    rng = np.random.default_rng(6)
    n, e = 900, 7000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    ptr, cols = coo_to_csr(src, dst, n)
    cfg = TileConfig(blk_h=64, blk_w=32, edge_chunk=16)
    from tcgnn.sgt import native

    if not native.available():
        pytest.skip("no native lib")
    m_nat = sparse_graph_translate(ptr, cols, n, cfg, impl="native")
    m_np = sparse_graph_translate(ptr, cols, n, cfg, impl="numpy")
    for f in (
        "chunk_r", "chunk_c", "chunk_edge_id", "chunk_block",
        "chunk_window", "chunk_first_in_window", "chunk_first_in_block",
        "edge_perm",
    ):
        np.testing.assert_array_equal(
            getattr(m_nat, f), getattr(m_np, f), err_msg=f
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_vs_numpy_fuzz_multigraph(seed):
    """Random multigraphs (duplicate edges, empty windows, isolated tail
    rows): native and numpy translations agree on every emitted field."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 400))
    e = int(rng.integers(10, 2000))
    src = rng.integers(0, max(n - 7, 1), e)  # leave empty tail windows
    dst = rng.integers(0, max(n - 7, 1), e)
    dup = rng.integers(0, e, e // 3)  # force duplicate edges
    src = np.concatenate([src, src[dup]])
    dst = np.concatenate([dst, dst[dup]])
    ptr, cols = coo_to_csr(src, dst, n)
    cfg = TileConfig(blk_h=32, blk_w=16, edge_chunk=8)
    from tcgnn.sgt import native

    if not native.available():
        pytest.skip("no native lib")
    m_nat = sparse_graph_translate(ptr, cols, n, cfg, impl="native",
                                   build_tiles=True)
    m_np = sparse_graph_translate(ptr, cols, n, cfg, impl="numpy",
                                  build_tiles=True)
    for f in (
        "block_partition", "col_ids", "block_window",
        "block_first_in_window", "edge_pos", "a_tiles",
        "chunk_r", "chunk_c", "chunk_edge_id", "chunk_block",
        "chunk_window", "chunk_first_in_window", "chunk_first_in_block",
        "edge_perm",
    ):
        np.testing.assert_array_equal(
            np.asarray(getattr(m_nat, f)), np.asarray(getattr(m_np, f)),
            err_msg=f"{f} seed={seed}",
        )
    assert m_nat.num_real_blocks == m_np.num_real_blocks


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_vs_numpy_bd_extract_fuzz(seed):
    """Native block-diagonal extraction (sgt.cpp:sgt_bd_hist/sgt_bd_fill)
    vs the numpy pass on random banded / power-law / multigraph inputs:
    identical selection, streams, tile contents, and packed indices."""
    from tcgnn.sgt import blockdiag as bd

    if not native.available():
        pytest.skip("no native lib")

    rng = np.random.default_rng(seed)
    n = int(rng.integers(60, 2500))
    e = int(rng.integers(2, 6 * n))
    mode = seed % 4
    src = rng.integers(0, n, e)
    if mode == 3:  # unbanded (power-law-ish): exercises the None gate
        dst = rng.integers(0, n, e)
    else:
        band = int(rng.integers(1, 300))
        dst = np.clip(src + rng.integers(-band, band + 1, e), 0, n - 1)
    if mode == 1:  # duplicate edges (multigraph tile counts)
        dup = rng.integers(0, e, e // 8)
        src = np.concatenate([src, src[dup]])
        dst = np.concatenate([dst, dst[dup]])
    ptr, cols = coo_to_csr(src, dst, n)

    for cand in (None, (0, -1, 1)):
        kw = dict(
            bin_rows=128, candidate_offsets=cand,
            min_coverage=0.0 if mode == 2 else 0.85,
        )
        m_nat = bd.extract_block_diag(ptr, cols, n, **kw)
        # Force the numpy reference path.
        orig = native.available
        native.available = lambda: False
        try:
            m_np = bd.extract_block_diag(ptr, cols, n, **kw)
        finally:
            native.available = orig
        assert (m_nat is None) == (m_np is None), (seed, cand)
        if m_nat is None:
            continue
        assert m_nat.offsets == m_np.offsets
        assert abs(m_nat.coverage - m_np.coverage) < 1e-12
        np.testing.assert_array_equal(
            m_nat.packed_cov_idx(), m_np.packed_cov_idx()
        )
        for f in (
            "tile_idx", "tile_cnt", "cov_edge_ids", "cov_flat_idx",
            "res_ptr", "res_idx", "res_edge_ids",
        ):
            x, y = getattr(m_nat, f), getattr(m_np, f)
            if x is None and y is None:
                continue
            np.testing.assert_array_equal(x, y, err_msg=f"{f} seed={seed}")
