"""Synthetic graph generation matching the reference's AE dataset matrix.

The reference's artifact evaluation runs a fixed 14-graph table
(``/root/reference/1_bench_gcn.py:10-28``) loaded from ``tcgnn-ae-graphs/``
``.npz`` files that are *not* shipped with the repo (downloaded separately
in its AE flow).  Under zero-egress we reproduce the workload shapes
instead: same node/edge scale, feature dim, and class count per name, with
a power-law degree distribution plus locality (the graphs' small
``avg_edgeSpan``), symmetrized like the originals.

If a real ``.npz`` with the reference contract exists under ``--data_dir``,
the loaders in :mod:`tcgnn.data.dataset` are used instead — synthetic
generation is only the fallback.
"""

from __future__ import annotations

import numpy as np

from tcgnn.data.dataset import GraphDataset, _finalize

# name -> (num_nodes, num_directed_edges, feature_dim, num_classes)
# Scales follow the published TC-GNN AE dataset table (paper Table 2 /
# 1_bench_gcn.py:10-28 for dims & classes).
AE_DATASETS = {
    "citeseer": (3327, 9104, 3703, 6),
    "cora": (2708, 10556, 1433, 7),
    "pubmed": (19717, 88648, 500, 3),
    "ppi": (56944, 818716, 50, 121),
    "PROTEINS_full": (43471, 162088, 29, 2),
    "OVCAR-8H": (1890931, 3946402, 66, 2),
    "Yeast": (1714644, 3636546, 74, 2),
    "DD": (334925, 1686092, 89, 2),
    "YeastH": (3139988, 6487230, 75, 2),
    "amazon0505": (410236, 4878874, 96, 22),
    "artist": (50515, 1638396, 100, 12),
    "com-amazon": (334863, 925872, 96, 22),
    "soc-BlogCatalog": (88784, 2093195, 128, 39),
    "amazon0601": (403394, 3387388, 96, 22),
    "reddit": (232965, 114615892, 602, 41),
}


# TUDataset graph collections among the AE names: these are disjoint unions
# of many small molecule/protein graphs (name -> approx. number of member
# graphs, from the published TUDataset statistics; YeastH's 3139988/79601 =
# 39.4 avg nodes cross-checks the with-hydrogen molecule sizes).  Generating
# them as power-law graphs would be structurally wrong — the component
# structure is exactly what SGT (and the reference's real-graph numbers,
# /root/reference/logs/reduce_blocks.csv) exploit.
TU_COLLECTIONS = {
    "PROTEINS_full": 1113,
    "DD": 1178,
    "OVCAR-8H": 40516,
    "Yeast": 79601,
    "YeastH": 79601,
}


def component_union_graph(
    num_nodes: int,
    num_edges: int,
    num_graphs: int,
    seed: int = 0,
):
    """Disjoint union of small connected graphs (TUDataset-class structure).

    Component sizes are lognormal around ``num_nodes/num_graphs`` (min 3);
    each component is a random spanning path plus uniform extra edges within
    the component until the global undirected pair budget ``num_edges/2`` is
    met.  Node ids are component-contiguous, as in the reference's real
    ``.npz`` files (TUDataset concatenation order).
    Returns (src, dst) directed, symmetrized, deduplicated.
    """
    rng = np.random.default_rng(seed)
    mean = num_nodes / num_graphs
    sizes = np.maximum(
        3, np.round(rng.lognormal(np.log(mean) - 0.125, 0.5, num_graphs))
    ).astype(np.int64)
    # Rescale to sum to num_nodes exactly (spread the drift over components).
    sizes = np.maximum(3, np.round(sizes * (num_nodes / sizes.sum()))).astype(np.int64)
    drift = num_nodes - int(sizes.sum())
    step = 1 if drift > 0 else -1
    idx = rng.choice(num_graphs, size=abs(drift) % num_graphs, replace=False)
    bulk, rem = divmod(abs(drift), num_graphs)
    sizes += step * bulk
    sizes[idx] += step
    sizes = np.maximum(sizes, 3)
    # final exact fix on the largest component (absorbs clamping residue)
    sizes[np.argmax(sizes)] += num_nodes - int(sizes.sum())

    starts = np.zeros(num_graphs + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])

    # Spanning paths: (i, i+1) for every i that is not a component's last.
    ids = np.arange(num_nodes - 1, dtype=np.int64)
    not_last = np.ones(num_nodes - 1, dtype=bool)
    not_last[starts[1:-1] - 1] = False
    pa, pb = ids[not_last], ids[not_last] + 1
    path_keys = pa * np.int64(num_nodes) + pb

    target_pairs = max(num_edges // 2, 1)
    keys = path_keys
    for _ in range(8):
        deficit = target_pairs - len(keys)
        if deficit <= 0:
            break
        n_draw = int(deficit * 1.5) + 16
        u = rng.integers(0, num_nodes, size=n_draw)
        comp = np.searchsorted(starts, u, side="right") - 1
        v = starts[comp] + np.floor(
            rng.random(n_draw) * sizes[comp]
        ).astype(np.int64)
        keep = u != v
        a = np.minimum(u[keep], v[keep])
        b = np.maximum(u[keep], v[keep])
        keys = np.unique(np.concatenate([keys, a * np.int64(num_nodes) + b]))
    if len(keys) > target_pairs:
        # Keep every path edge (connectivity); trim extras only.
        extra = np.setdiff1d(keys, path_keys, assume_unique=False)
        n_keep = target_pairs - len(path_keys)
        if n_keep > 0:
            extra = rng.choice(extra, size=min(n_keep, len(extra)), replace=False)
            keys = np.concatenate([path_keys, extra])
        else:
            keys = path_keys
    a, b = keys // num_nodes, keys % num_nodes
    return np.concatenate([a, b]), np.concatenate([b, a])


def powerlaw_graph(
    num_nodes: int,
    num_edges: int,
    seed: int = 0,
    alpha: float = 2.1,
    locality: float = 0.7,
):
    """COO edge list with Zipf-ish degrees and locality, symmetrized.

    ``locality`` is the fraction of endpoints drawn near the source node
    (keeps avg_edgeSpan small, like the AE graphs' community structure).
    Returns (src, dst) with ~num_edges directed edges (both directions of
    each undirected pair, self-loop-free, deduplicated).
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_nodes)
    target_pairs = max(num_edges // 2, 1)

    # Dense graphs (reddit-class, avg degree ~500): Zipf pair-sampling
    # saturates on hub collisions long before the target and each top-up
    # round re-sorts the full key set — O(10 min) and ~7x short on edges.
    # Sample a per-source degree sequence instead: duplicates are then
    # rare (per-node birthday bound, not per-hub), one dedup suffices.
    if num_edges // max(num_nodes, 1) > 64:
        ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
        w = ranks ** (-(alpha - 1.0))  # Zipf-ish expected-degree profile
        cap = max(num_nodes // 16, 1024)  # hubs can't exceed N neighbors
        scale = target_pairs / w.sum()
        for _ in range(4):  # rescale uncapped mass to absorb capped excess
            deg = np.minimum(cap, np.maximum(1, np.round(w * scale)))
            short = target_pairs - deg.sum()
            uncapped = w[deg < cap].sum()
            if short <= 0 or uncapped <= 0:
                break
            scale += short / uncapped
        deg = deg.astype(np.int64)[np.argsort(perm)]
        span = max(int(num_nodes * 0.02), 8)
        keys = np.empty(0, dtype=np.int64)
        for rnd in range(4):
            src = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
            m = len(src)
            loc_frac = locality if rnd == 0 else 0.0  # top-ups go global
            local = (src + rng.integers(-span, span + 1, size=m)) % num_nodes
            glob = rng.integers(0, num_nodes, size=m)
            dst = np.where(rng.random(m) < loc_frac, local, glob)
            keep = src != dst
            a = np.minimum(src[keep], dst[keep])
            b = np.maximum(src[keep], dst[keep])
            keys = np.unique(
                np.concatenate([keys, a * np.int64(num_nodes) + b])
            )
            deficit = target_pairs - len(keys)
            if deficit <= 0:
                break
            # resample the shortfall proportional to the degree profile
            deg = np.maximum(
                np.round(deg * (deficit / max(deg.sum(), 1))), 1
            ).astype(np.int64)
        a, b = keys // num_nodes, keys % num_nodes
        return np.concatenate([a, b]), np.concatenate([b, a])

    keys = np.empty(0, dtype=np.int64)
    # Zipf sampling + dedup collapses heavily on hubs; top up in rounds
    # until the undirected pair count reaches the target.
    for _ in range(8):
        deficit = target_pairs - len(keys)
        if deficit <= 0:
            break
        n_pairs = int(deficit * 1.6) + 16

        # Power-law source sampling via Zipf over a permuted id space.
        ranks = rng.zipf(alpha, size=n_pairs)
        ranks = np.clip(ranks, 1, num_nodes) - 1
        src = perm[ranks]

        # Destinations: mixture of local (gaussian around src) and global.
        local = np.clip(
            src + np.round(rng.standard_normal(n_pairs) * max(num_nodes * 0.001, 4.0)).astype(np.int64),
            0,
            num_nodes - 1,
        )
        glob = rng.integers(0, num_nodes, size=n_pairs)
        take_local = rng.random(n_pairs) < locality
        dst = np.where(take_local, local, glob)

        keep = src != dst
        src, dst = src[keep], dst[keep]
        a = np.minimum(src, dst).astype(np.int64)
        b = np.maximum(src, dst).astype(np.int64)
        keys = np.unique(np.concatenate([keys, a * np.int64(num_nodes) + b]))

    if len(keys) > target_pairs:
        keys = rng.choice(keys, size=target_pairs, replace=False)
    a, b = keys // num_nodes, keys % num_nodes
    return np.concatenate([a, b]), np.concatenate([b, a])


def synthesize(name: str, dim: int | None = None, num_classes: int | None = None, seed: int = 0) -> GraphDataset:
    """Build the named AE-scale synthetic graph (or a custom one via
    ``name='rand_<N>_<E>'``)."""
    planted = name.startswith("planted_")
    if name in AE_DATASETS:
        n, e, d, c = AE_DATASETS[name]
        dim = dim if dim is not None else d
        num_classes = num_classes if num_classes is not None else c
    elif name.startswith("rand_") or planted:
        _, n, e = name.split("_")
        n, e = int(n), int(e)
        dim = dim if dim is not None else 96
        num_classes = num_classes if num_classes is not None else 10
    else:
        raise ValueError(
            f"unknown synthetic dataset {name!r}; known: {sorted(AE_DATASETS)},"
            " rand_<N>_<E>, or planted_<N>_<E>"
        )
    if name in TU_COLLECTIONS:
        src, dst = component_union_graph(n, e, TU_COLLECTIONS[name], seed=seed)
    else:
        src, dst = powerlaw_graph(n, e, seed=seed)
    if planted:
        # Guarantee connectivity + self-contribution: ring edges keep every
        # node reachable and self-loops let aggregation retain the node's
        # own signal (A+I, the standard GCN formulation the reference's
        # models omit).
        ring = np.arange(n, dtype=np.int64)
        src = np.concatenate([src, ring, (ring + 1) % n, ring])
        dst = np.concatenate([dst, (ring + 1) % n, ring, ring])
    ds = _finalize(name, src, dst, n, dim, num_classes, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if planted:
        # Learnable node-classification task: contiguous communities (which
        # the generator's locality makes structurally assortative) with a
        # weak per-class feature signal that neighbor aggregation denoises.
        # Used for real accuracy runs — the reference only ever trains
        # against all-ones labels (dataset.py:122).
        ds.y = (np.arange(n, dtype=np.int64) * num_classes // n).astype(np.int32)
        mu = rng.standard_normal((num_classes, ds.num_features)).astype(np.float32)
        ds.x = (
            0.6 * mu[ds.y] + rng.standard_normal(ds.x.shape).astype(np.float32)
        )
        # honest split: disjoint random train/val/test
        perm = rng.permutation(n)
        ds.train_mask[:] = ds.val_mask[:] = ds.test_mask[:] = False
        ds.train_mask[perm[: int(n * 0.6)]] = True
        ds.val_mask[perm[int(n * 0.6) : int(n * 0.8)]] = True
        ds.test_mask[perm[int(n * 0.8) :]] = True
    else:
        # Random (balanced) labels so NLL training is non-degenerate; the
        # reference trains against all-ones labels (dataset.py:122) — keep
        # that behaviour reachable via y = ones.
        ds.y = rng.integers(0, num_classes, size=n).astype(np.int32)
    return ds
