"""RCM reordering: permutation correctness + training invariance."""

import jax
import jax.numpy as jnp
import numpy as np

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph, synthesize
from tcgnn.graph import TiledGraph
from tcgnn.ops.reference import spmm_ref
from tcgnn.sgt.reorder import (
    community_permutation,
    permute_csr,
    rcm_permutation,
    reorder_dataset,
)

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)


def test_permute_csr_is_isomorphic():
    n = 120
    src, dst = powerlaw_graph(n, 800, seed=3)
    ptr, cols = coo_to_csr(src, dst, n)
    perm = rcm_permutation(ptr, cols, n)
    new_ptr, new_cols, edge_map = permute_csr(ptr, cols, perm)

    # adjacency sets must match under the relabeling
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    old_edges = set()
    for r in range(n):
        for e in range(ptr[r], ptr[r + 1]):
            old_edges.add((inv[r], inv[cols[e]]))
    new_edges = set()
    for r in range(n):
        for e in range(new_ptr[r], new_ptr[r + 1]):
            new_edges.add((r, new_cols[e]))
    assert old_edges == new_edges
    # per-row columns sorted (CSR convention)
    for r in range(n):
        seg = new_cols[new_ptr[r] : new_ptr[r + 1]]
        assert (np.diff(seg) > 0).all()


def test_spmm_invariant_under_reorder():
    """P A P^T (P x) == P (A x): aggregation commutes with relabeling."""
    n, d = 150, 12
    src, dst = powerlaw_graph(n, 900, seed=5)
    ptr, cols = coo_to_csr(src, dst, n)
    x = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)

    perm = rcm_permutation(ptr, cols, n)
    new_ptr, new_cols, _ = permute_csr(ptr, cols, perm)

    base = np.asarray(spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols)))
    g = TiledGraph(new_ptr, new_cols, n, CFG)
    got = np.asarray(g.spmm(jnp.asarray(x[perm])))
    np.testing.assert_allclose(got, base[perm], rtol=1e-4, atol=1e-4)


def test_reorder_dataset_reduces_or_keeps_blocks():
    ds = synthesize("rand_5000_40000", dim=8, num_classes=3, seed=1)
    from tcgnn.sgt.translate import count_blocks

    b0 = count_blocks(ds.row_pointers, ds.column_index, ds.num_nodes, CFG)
    reorder_dataset(ds, "rcm")
    b1 = count_blocks(ds.row_pointers, ds.column_index, ds.num_nodes, CFG)
    assert b1 <= b0 * 1.1  # never catastrophically worse
    # dataset stays structurally valid
    assert ds.row_pointers[-1] == len(ds.column_index)
    assert ds.x.shape[0] == ds.num_nodes


def test_community_permutation_is_valid_and_invariant():
    """Rabbit-style ordering: valid permutation; aggregation commutes."""
    n, d = 160, 8
    src, dst = powerlaw_graph(n, 1000, seed=7)
    ptr, cols = coo_to_csr(src, dst, n)
    perm = community_permutation(ptr, cols, n)
    assert sorted(perm.tolist()) == list(range(n))

    x = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    new_ptr, new_cols, _ = permute_csr(ptr, cols, perm)
    base = np.asarray(spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols)))
    g = TiledGraph(new_ptr, new_cols, n, CFG)
    got = np.asarray(g.spmm(jnp.asarray(x[perm])))
    np.testing.assert_allclose(got, base[perm], rtol=1e-4, atol=1e-4)


def test_community_recovers_scrambled_clusters():
    """Scrambled planted clusters: community ordering restores locality.

    Build 64 dense 16-node cliques-ish clusters, scramble node ids, and
    check the Rabbit-style ordering brings the SGT block count back near
    the unscrambled optimum while random ids stay far worse.
    """
    rng = np.random.default_rng(11)
    n, k = 1024, 64
    csize = n // k
    src, dst = [], []
    for c in range(k):
        base = c * csize
        for _ in range(csize * 4):
            i, j = rng.integers(0, csize, 2)
            if i != j:
                src.append(base + i)
                dst.append(base + j)
    src, dst = np.asarray(src), np.asarray(dst)
    scramble = rng.permutation(n)
    ptr0, cols0 = coo_to_csr(src, dst, n)                    # ideal ids
    ptr1, cols1 = coo_to_csr(scramble[src], scramble[dst], n)  # scrambled

    from tcgnn.sgt.translate import count_blocks

    cfg = TileConfig(blk_h=64, blk_w=16, edge_chunk=16)
    ideal = count_blocks(ptr0, cols0, n, cfg)
    scrambled = count_blocks(ptr1, cols1, n, cfg)
    perm = community_permutation(ptr1, cols1, n)
    ptr2, cols2, _ = permute_csr(ptr1, cols1, perm)
    recovered = count_blocks(ptr2, cols2, n, cfg)
    assert scrambled > ideal * 2          # scrambling really hurt
    assert recovered <= ideal * 1.5       # ordering recovered the clusters


def test_reorder_permutes_masks_consistently():
    ds = synthesize("planted_500_3000", dim=8, num_classes=3, seed=4)
    y_of_train = set(ds.y[ds.train_mask].tolist())
    n_train = int(ds.train_mask.sum())
    reorder_dataset(ds, "rcm")
    assert int(ds.train_mask.sum()) == n_train
    # labels selected by the mask are the same multiset after the permutation
    assert set(ds.y[ds.train_mask].tolist()) == y_of_train
    assert not (ds.train_mask & ds.test_mask).any()
