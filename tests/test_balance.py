"""Window-granular LPT shard balance (sgt.reorder.shard_balance_permutation).

The distributed stacked metadata pads every shard to the heaviest shard's
block count, so the whole mesh executes Bmax grid steps per op; balancing
window→shard assignment minimizes Bmax (reddit-class flat block
distributions: 1.75x fewer at G=8 vs the contiguous split; measured in
RESULTS.md). These tests pin the permutation's invariants and the
end-to-end distributed correctness through ``distributed_graph_from_dataset
(balance="auto")``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.synthetic import synthesize
from tcgnn.ops.reference import spmm_ref
from tcgnn.parallel import distributed_graph_from_dataset, make_mesh
from tcgnn.sgt.reorder import (
    apply_permutation,
    balance_dataset,
    shard_balance_permutation,
)

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)


def _loads(ptr, cols, n, g, cfg):
    """Per-shard padded block loads for the contiguous window split."""
    from tcgnn.sgt import native
    from tcgnn.sgt.translate import _cdiv, _pad_blocks

    w = max(_cdiv(n, cfg.blk_h), 1)
    per = native.count_blocks(
        np.ascontiguousarray(ptr, np.int64),
        np.ascontiguousarray(cols, np.int32),
        cfg.blk_h, cfg.blk_w,
    )
    per = np.pad(per, (0, w - len(per)))
    per = _pad_blocks(per.astype(np.int64), cfg)
    wd = _cdiv(w, g)
    return np.pad(per, (0, g * wd - w)).reshape(g, wd).sum(1)


def _skewed_csr(n, seed=0):
    """Random graph + a clump of hub-ish rows at the front (skewed loads)."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, n).clip(0, n - 1)
    deg[: n // 10] = n // 3  # heavy head -> heavy first windows
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    return ptr.astype(np.int32), np.concatenate(cols).astype(np.int32)


def test_permutation_valid_and_window_granular():
    n, g = 1000, 4
    ptr, cols = _skewed_csr(n)
    perm = shard_balance_permutation(ptr, cols, n, g, CFG)
    assert sorted(perm.tolist()) == list(range(n))
    # Window-granular: every full window moves as one blk_h-aligned unit.
    blk = CFG.blk_h
    full = n // blk * blk
    starts = perm[np.arange(0, full, blk)]
    assert np.all(starts % blk == 0)
    for j in range(0, full, blk):
        np.testing.assert_array_equal(perm[j:j + blk], perm[j] + np.arange(blk))
    # A partial last window stays the globally-last slot.
    if n % blk:
        assert perm[full] % blk == 0 and perm[-1] == n - 1


def test_balance_reduces_max_shard_load():
    n, g = 1000, 4
    ptr, cols = _skewed_csr(n)
    before = _loads(ptr, cols, n, g, CFG)
    perm = shard_balance_permutation(ptr, cols, n, g, CFG)
    from tcgnn.sgt.reorder import permute_csr

    new_ptr, new_cols, _ = permute_csr(ptr, cols, perm)
    after = _loads(new_ptr, new_cols, n, g, CFG)
    assert after.sum() == before.sum()  # window contents untouched
    assert after.max() <= before.max()
    # The skewed head must actually spread (strict improvement).
    assert after.max() < before.max()


def test_distributed_balanced_matches_reference():
    mesh = make_mesh(n_graph=4, n_feature=2)
    ds = synthesize("rand_600_6000", seed=2)
    # Skew the degrees so balance is not a no-op.
    ptr, cols = _skewed_csr(600, seed=5)
    ds.row_pointers, ds.column_index = ptr, cols
    dg = distributed_graph_from_dataset(ds, mesh, CFG, balance="auto")
    n, d = ds.num_nodes, 24
    x = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    out = jax.jit(dg.spmm)(dg.shard_features(x))
    # ds was permuted in place; the reference uses the same (balanced) CSR.
    want = np.asarray(
        spmm_ref(
            jnp.asarray(x),
            jnp.asarray(ds.row_pointers),
            jnp.asarray(ds.column_index),
        )
    )
    np.testing.assert_allclose(np.asarray(out)[:n, :d], want, rtol=1e-4, atol=1e-4)


def test_balance_dataset_moves_features_with_rows():
    n, g = 640, 4
    ptr, cols = _skewed_csr(n, seed=7)
    ds = synthesize("rand_640_4000", seed=0)
    ds.row_pointers, ds.column_index = ptr, cols
    x0 = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 4), np.float32)
    ds.x = x0.copy()
    ds.y = np.arange(n) % 3
    perm = balance_dataset(ds, g, CFG)
    if perm is None:
        pytest.skip("identity balance on this instance")
    np.testing.assert_array_equal(ds.x[:, 0].astype(np.int64), perm)
    np.testing.assert_array_equal(ds.y, perm % 3)


def test_forced_block_diag_never_mutates_dataset():
    """block_diag=True on a non-BD graph must raise WITHOUT permuting ds."""
    mesh = make_mesh(n_graph=4, n_feature=2)
    ptr, cols = _skewed_csr(600, seed=9)
    ds = synthesize("rand_600_6000", seed=1)
    ds.row_pointers, ds.column_index = ptr, cols
    x_before = np.asarray(ds.x).copy()
    with pytest.raises(ValueError):
        distributed_graph_from_dataset(ds, mesh, CFG, block_diag=True)
    np.testing.assert_array_equal(np.asarray(ds.x), x_before)


def test_bd_graphs_skip_balance():
    """Block-diagonal graphs must NOT be window-shuffled."""
    mesh = make_mesh(n_graph=4, n_feature=2)
    # Pure block-diagonal graph: disjoint 16-node cliques (bin_rows=128
    # default BD geometry needs blk multiples; use the library gate itself).
    from tcgnn.parallel.graph import probe_block_diag

    n = 1024
    blocks = [np.arange(i, i + 16) for i in range(0, n, 16)]
    ptr = np.zeros(n + 1, np.int64)
    cols = []
    for b in blocks:
        for r in b:
            cols.append(b)
            ptr[r + 1] = len(b)
    np.cumsum(ptr, out=ptr)
    cols = np.concatenate(cols).astype(np.int32)
    ok, *_ = probe_block_diag(ptr.astype(np.int32), cols, n, 4)
    if not ok:
        pytest.skip("instance not BD-gated at this geometry")
    ds = synthesize("rand_1024_4000", seed=0)
    ds.row_pointers, ds.column_index = ptr.astype(np.int32), cols
    x_before = np.asarray(ds.x).copy()
    dg = distributed_graph_from_dataset(ds, mesh, balance="auto")
    assert dg.block_diag
    np.testing.assert_array_equal(np.asarray(ds.x), x_before)  # untouched
