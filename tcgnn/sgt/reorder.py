"""Graph reordering to raise SGT condensation efficiency.

The TC-GNN paper pairs SGT with node reordering (its sibling repos use
Rabbit ordering; ``/root/reference/README.md`` "+Rabbit" variants) so that
rows mapped to the same window share neighbors.  This matters twice:
fewer TC blocks *and* fewer condensed-gather rows — window-level neighbor
sharing is the main lever on power-law graphs.

Reordering is a graph isomorphism: permute rows+cols of A and the node
features/labels identically; training semantics are unchanged (full-graph
loss is permutation-invariant).  ``reverse_cuthill_mckee`` (scipy) is the
bandwidth-minimizing classic and needs no extra deps.
"""

from __future__ import annotations

import numpy as np


def rcm_permutation(row_pointers, column_index, num_nodes: int) -> np.ndarray:
    """perm[new_id] = old_id via reverse Cuthill-McKee on A + A^T.

    Uses the native C++ BFS implementation when built (~70x faster than
    scipy's on multi-million-edge graphs); scipy is the fallback.
    """
    import scipy.sparse as sp

    indptr = np.asarray(row_pointers, dtype=np.int64)
    indices = np.asarray(column_index, dtype=np.int64)
    data = np.ones(len(indices), dtype=np.int8)
    a = sp.csr_matrix((data, indices, indptr), shape=(num_nodes, num_nodes))
    s = (a + a.T).tocsr()

    from tcgnn.sgt import native

    if native.available():
        return native.rcm(
            s.indptr.astype(np.int64), s.indices.astype(np.int32)
        )
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(s, symmetric_mode=True), dtype=np.int64)


def community_permutation(row_pointers, column_index, num_nodes: int) -> np.ndarray:
    """perm[new_id] = old_id via Rabbit-style community aggregation.

    The ordering the TC-GNN README pairs with SGT ("+Rabbit" variants,
    ``/root/reference/README.md``): single-pass modularity-gain merging with
    dendrogram-DFS ids (native C++, ``sgt.cpp:sgt_community``).  Best on
    power-law / co-purchase graphs where RCM's bandwidth objective has no
    band to find; falls back to RCM when the native library is missing.
    """
    import scipy.sparse as sp

    indptr = np.asarray(row_pointers, dtype=np.int64)
    indices = np.asarray(column_index, dtype=np.int64)
    data = np.ones(len(indices), dtype=np.int8)
    a = sp.csr_matrix((data, indices, indptr), shape=(num_nodes, num_nodes))
    s = (a + a.T).tocsr()

    from tcgnn.sgt import native

    if native.available():
        return native.community(
            s.indptr.astype(np.int64), s.indices.astype(np.int32)
        )
    return rcm_permutation(row_pointers, column_index, num_nodes)


def permute_csr(row_pointers, column_index, perm: np.ndarray):
    """CSR of P A P^T where new node i = old node perm[i].

    Returns (new_ptr, new_cols, edge_map) with ``edge_map[new_edge] =
    old_edge`` so per-edge vectors can follow the relabeling.
    """
    ptr = np.asarray(row_pointers, dtype=np.int64)
    cols = np.asarray(column_index, dtype=np.int64)
    n = len(ptr) - 1
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)

    degrees = np.diff(ptr)
    new_degrees = degrees[perm]
    new_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(new_degrees, out=new_ptr[1:])

    # For each new row r (old row perm[r]), copy its old edge slice.
    old_starts = ptr[perm]
    edge_map = np.empty(len(cols), dtype=np.int64)
    idx_within = np.arange(len(cols), dtype=np.int64) - np.repeat(
        new_ptr[:-1], new_degrees
    )
    edge_map = np.repeat(old_starts, new_degrees) + idx_within
    new_cols_unsorted = inv[cols[edge_map]]

    # Keep each row's columns sorted (CSR convention the SGT pass expects).
    # Single combined-key argsort (row * n + col fits int64) is ~2x faster
    # than a two-key lexsort on multi-million-edge graphs.
    row_of_new_edge = np.repeat(np.arange(n, dtype=np.int64), new_degrees)
    order = np.argsort(
        row_of_new_edge * np.int64(n) + new_cols_unsorted, kind="stable"
    )
    return (
        new_ptr.astype(np.int32),
        new_cols_unsorted[order].astype(np.int32),
        edge_map[order],
    )


def apply_permutation(ds, perm: np.ndarray):
    """Permute a GraphDataset in place (graph + features + labels + masks)."""
    new_ptr, new_cols, _ = permute_csr(ds.row_pointers, ds.column_index, perm)
    ds.row_pointers = new_ptr
    ds.column_index = new_cols
    ds.x = np.asarray(ds.x)[perm]
    ds.y = np.asarray(ds.y)[perm]
    for m in ("train_mask", "val_mask", "test_mask"):
        if getattr(ds, m, None) is not None:
            setattr(ds, m, np.asarray(getattr(ds, m))[perm])
    return perm


def reorder_dataset(ds, method: str = "rcm"):
    """Permute a GraphDataset in place (graph + features + labels).

    Returns the permutation used (perm[new] = old); ``None`` method is a
    no-op.
    """
    if method in (None, "none"):
        return None
    if method == "rcm":
        perm = rcm_permutation(ds.row_pointers, ds.column_index, ds.num_nodes)
    elif method == "community":
        perm = community_permutation(
            ds.row_pointers, ds.column_index, ds.num_nodes
        )
    else:
        raise ValueError(f"unknown reorder method {method!r}")
    return apply_permutation(ds, perm)


def shard_balance_permutation(
    row_pointers, column_index, num_nodes: int, num_shards: int, config=None
) -> np.ndarray:
    """perm[new] = old: window-granular shard load balancing.

    The distributed layer splits row windows into ``num_shards`` contiguous
    equal-count ranges (``parallel/partition.partition_csr``) and pads every
    shard's stacked metadata to the max shard's block count — so each shard
    *executes* the heaviest shard's kernel grid. Bandwidth orderings (RCM)
    concentrate dense windows at the band's ends, leaving the end shards
    3-25x heavier than the middle ones (measured: amazon0601 G=8 after RCM
    is 3200 blocks on shard 0 vs 99 mid-shard).

    This pass reassigns whole windows to shards by LPT (longest-processing-
    time greedy, equal window cardinality per shard — the partitioner's
    shard geometry), then relabels nodes so each shard's windows become
    contiguous. Window *contents* are untouched, so the per-window SGT
    tiling — and therefore TC_Blocks/Exp_Edges — is identical; only the
    window→shard assignment changes. Single-device runs are unaffected
    (window order is irrelevant there); the banded block-diagonal layout is
    destroyed, so callers must skip this pass when taking the BD path.
    """
    from tcgnn.config import DEFAULT_CONFIG
    from tcgnn.sgt import native
    from tcgnn.sgt.translate import _cdiv, _pad_blocks, sparse_graph_translate

    cfg = DEFAULT_CONFIG if config is None else config
    blk_h = cfg.blk_h
    n = int(num_nodes)
    g = int(num_shards)
    w = max(_cdiv(n, blk_h), 1)
    identity = np.arange(n, dtype=np.int64)
    if g <= 1 or w <= g:
        return identity

    # Per-window *padded* block counts = the load each window adds to its
    # shard's kernel grid (same padding rule as the stacked metadata).
    if native.available():
        per = native.count_blocks(
            np.ascontiguousarray(row_pointers, np.int64),
            np.ascontiguousarray(column_index, np.int32),
            blk_h, cfg.blk_w,
        )
        per = np.pad(per, (0, w - len(per))) if len(per) < w else per[:w]
    else:  # pragma: no cover - the native pass builds in-tree
        per = sparse_graph_translate(
            row_pointers, column_index, n, cfg, emit_chunks=False,
            build_tiles=False,
        ).block_partition
    load = _pad_blocks(np.asarray(per, np.int64), cfg).astype(np.int64)

    wd = _cdiv(w, g)
    caps = np.full(g, wd, np.int64)
    caps[-1] = w - (g - 1) * wd  # partitioner pads the tail shard
    if caps[-1] <= 0:  # degenerate tail shards own no real windows
        caps = np.minimum(np.maximum(w - np.arange(g) * wd, 0), wd)
    totals = np.zeros(g, np.float64)
    assign: list[list[int]] = [[] for _ in range(g)]

    # A partial last window (n % blk_h != 0) must stay the globally-last
    # slot: every preceding slot must hold a full window for the node
    # relabeling to keep windows blk_h-aligned. Pin it to the last
    # non-empty shard before the greedy pass.
    partial = n % blk_h != 0
    windows = np.arange(w - 1 if partial else w)
    if partial:
        s_last = int(np.max(np.nonzero(caps > 0)[0]))
        assign[s_last].append(w - 1)
        totals[s_last] += load[w - 1]
        caps[s_last] -= 1

    for w_id in windows[np.argsort(-load[windows], kind="stable")]:
        open_ = caps > 0
        s = int(np.flatnonzero(open_)[np.argmin(totals[open_])])
        assign[s].append(int(w_id))
        totals[s] += load[w_id]
        caps[s] -= 1

    slots: list[int] = []
    for s in range(g):
        ws = sorted(assign[s])  # ascending keeps band locality per shard
        if partial and (w - 1) in ws:
            ws = [v for v in ws if v != w - 1] + [w - 1]
        slots.extend(ws)
    return np.concatenate(
        [np.arange(v * blk_h, min((v + 1) * blk_h, n), dtype=np.int64) for v in slots]
    )


def balance_dataset(ds, num_shards: int, config=None):
    """Apply :func:`shard_balance_permutation` to a GraphDataset in place.

    Returns the permutation, or ``None`` when it would be the identity.
    """
    perm = shard_balance_permutation(
        ds.row_pointers, ds.column_index, ds.num_nodes, num_shards, config
    )
    if np.array_equal(perm, np.arange(ds.num_nodes, dtype=np.int64)):
        return None
    return apply_permutation(ds, perm)
