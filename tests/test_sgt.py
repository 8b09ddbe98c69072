"""SGT tiling pass unit tests.

The pure-Python tile counter in the reference
(/root/reference/3_cnt_TC_blk_SpMM.py:55-90) is effectively the spec for
the condensation math: per row window, #blocks = ceil(#unique_neighbors /
blk_w).  We check that, plus full edge-accounting round trips through the
uniform chunk layout.
"""

import numpy as np
import pytest

from tcgnn.config import GPU_REFERENCE_CONFIG, TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph
from tcgnn.sgt.translate import sparse_graph_translate, transpose_csr


def random_csr(num_nodes, num_edges, seed=0):
    src, dst = powerlaw_graph(num_nodes, num_edges, seed=seed)
    return coo_to_csr(src, dst, num_nodes)


def spec_block_counts(row_pointers, column_index, blk_h, blk_w):
    """Reference spec: 3_cnt_TC_blk_SpMM.py:55-68 (opt_cnt per window)."""
    n = len(row_pointers) - 1
    counts = []
    for start in range(0, n, blk_h):
        end = min(start + blk_h, n)
        neighbors = column_index[row_pointers[start] : row_pointers[end]]
        counts.append(-(-len(set(neighbors.tolist())) // blk_w) if len(neighbors) else 0)
    return counts


@pytest.mark.parametrize("config", [TileConfig(), GPU_REFERENCE_CONFIG, TileConfig(blk_h=8, blk_w=128, edge_chunk=64)])
@pytest.mark.parametrize("n,e", [(300, 2000), (1000, 5000), (65, 80)])
def test_block_partition_matches_spec(config, n, e):
    indptr, indices = random_csr(n, e, seed=n)
    meta = sparse_graph_translate(indptr, indices, n, config)
    spec = spec_block_counts(indptr, indices, config.blk_h, config.blk_w)
    # block_partition pads empty windows to >=1 and rounds up to the
    # dense-kernel group size (translate._pad_blocks); real-block count is
    # still the reference's TC_Blocks statistic.
    g = config.block_group
    assert list(meta.block_partition) == [-(-max(s, 1) // g) * g for s in spec]
    assert meta.num_real_blocks == sum(spec)


def densify_from_meta(meta):
    """Reconstruct the adjacency (with duplicate-edge counts) from the chunk
    layout — exactly what the kernels compute implicitly."""
    cfg = meta.config
    n_pad = meta.num_windows * cfg.blk_h
    a = np.zeros((n_pad, meta.num_nodes), dtype=np.int64)
    window_of_chunk = meta.chunk_window
    for ci in range(meta.num_chunks):
        blk = meta.chunk_block[ci]
        win = window_of_chunk[ci]
        for k in range(cfg.edge_chunk):
            r = meta.chunk_r[ci, k]
            if r == cfg.row_sentinel:
                continue
            c = meta.chunk_c[ci, k]
            col_global = meta.col_ids[blk * cfg.blk_w + c]
            a[win * cfg.blk_h + r, col_global] += 1
    return a[: meta.num_nodes]


def densify_from_csr(indptr, indices, n):
    a = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for e in range(indptr[i], indptr[i + 1]):
            a[i, indices[e]] += 1
    return a


@pytest.mark.parametrize("config", [TileConfig(blk_h=16, blk_w=8, edge_chunk=8), TileConfig(blk_h=32, blk_w=32, edge_chunk=16)])
def test_chunk_layout_reconstructs_adjacency(config):
    n, e = 200, 1200
    indptr, indices = random_csr(n, e, seed=7)
    meta = sparse_graph_translate(indptr, indices, n, config)
    np.testing.assert_array_equal(
        densify_from_meta(meta), densify_from_csr(indptr, indices, n)
    )


def test_edge_perm_roundtrip():
    n, e = 150, 900
    indptr, indices = random_csr(n, e, seed=3)
    meta = sparse_graph_translate(indptr, indices, n, TileConfig(blk_h=16, blk_w=8, edge_chunk=8))
    # Scatter per-edge ids through the chunk layout and gather back.
    flat = meta.chunk_edge_id.reshape(-1)
    gathered = flat[meta.edge_perm]
    np.testing.assert_array_equal(gathered, np.arange(meta.num_edges))
    # Padding slots carry the sentinel edge id.
    real_slots = np.zeros(flat.shape, dtype=bool)
    real_slots[meta.edge_perm] = True
    assert (flat[~real_slots] == meta.num_edges).all()


def test_empty_windows_get_padding_chunks():
    # Nodes 0..15 have edges, 16..63 have none -> windows 1..3 empty at blk_h=16.
    src = np.repeat(np.arange(16), 2)
    dst = np.tile(np.array([1, 2]), 16)
    indptr, indices = coo_to_csr(src, dst, 64)
    meta = sparse_graph_translate(indptr, indices, 64, TileConfig(blk_h=16, blk_w=8, edge_chunk=8))
    assert meta.num_windows == 4
    assert (meta.block_partition >= 1).all()
    # Every window appears among chunk_window (so every output tile is written).
    assert set(meta.chunk_window.tolist()) == {0, 1, 2, 3}
    assert meta.chunk_first_in_window.sum() == 4


def test_transpose_csr():
    n, e = 100, 600
    indptr, indices = random_csr(n, e, seed=11)
    t_ptr, t_idx, t_src = transpose_csr(indptr, indices, n)
    a = densify_from_csr(indptr, indices, n)
    at = densify_from_csr(t_ptr, t_idx, n)
    np.testing.assert_array_equal(at, a.T)
    # t_src maps transpose edges back to forward edges: scattering forward
    # edge ids through it must be a permutation.
    assert sorted(t_src.tolist()) == list(range(len(indices)))


def test_chunk_scalars_consistent():
    n, e = 500, 3000
    indptr, indices = random_csr(n, e, seed=5)
    meta = sparse_graph_translate(indptr, indices, n)
    # chunk_window non-decreasing; chunk_block non-decreasing.
    assert (np.diff(meta.chunk_window) >= 0).all()
    assert (np.diff(meta.chunk_block) >= 0).all()
    # first_in_window implies first_in_block.
    fw = meta.chunk_first_in_window.astype(bool)
    fb = meta.chunk_first_in_block.astype(bool)
    assert (fb | ~fw).all()
    assert fw.sum() == meta.num_windows
    assert fb.sum() == meta.num_blocks
