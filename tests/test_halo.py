"""Boundary-only halo exchange: structure, remap correctness, scaling.

SURVEY §2.3 / BASELINE.json call for *boundary feature* exchange between devices
— not a full feature-matrix all_gather.  These tests pin down the
partition-time halo structures (``partition.build_halo``) and the memory
property: the extended slab each device assembles is
O(rows_per_shard + boundary), independent of N for banded graphs.
"""

import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.parallel.partition import partition_graph

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)


def banded_csr(n, band=3):
    """Symmetric banded graph: node i ~ i±1..band."""
    rows, cols = [], []
    for i in range(n):
        for d in range(-band, band + 1):
            j = i + d
            if d != 0 and 0 <= j < n:
                rows.append(i)
                cols.append(j)
    rows, cols = np.asarray(rows), np.asarray(cols)
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptr[1:])
    return ptr.astype(np.int32), cols.astype(np.int32)


def test_halo_capacity_is_boundary_sized():
    """Banded graph: each shard needs only O(band) remote rows, regardless
    of N — the defining property of a boundary-only exchange.  With the
    per-offset plan a banded graph exchanges ONLY with its two neighbor
    offsets (1 and G-1); far offsets emit no collective at all."""
    band = 3
    for n in (256, 1024):
        ptr, cols = banded_csr(n, band)
        fwd, bwd = partition_graph(ptr, cols, n, 4, CFG)
        assert fwd.halo["capacity"] <= band
        assert bwd.halo["capacity"] <= band
        offsets = {o for o, _ in fwd.halo["offset_caps"]}
        assert offsets <= {1, fwd.num_shards - 1}, offsets
        assert fwd.halo["halo_rows"] <= 2 * band
        # extended slab size vs the full matrix an all_gather would hold
        ext_rows = fwd.rows_per_shard + fwd.halo["halo_rows"]
        assert ext_rows < fwd.padded_nodes or fwd.num_shards == 1


def test_send_idx_rows_are_local():
    ptr, cols = banded_csr(600, 4)
    fwd, _ = partition_graph(ptr, cols, 600, 4, CFG)
    send = fwd.halo["send_idx"]  # [G, halo_rows]
    assert send.ndim == 2 and send.shape[0] == fwd.num_shards
    assert send.min() >= 0 and send.max() < fwd.rows_per_shard


def _real_col_mask(meta, s):
    """[B*blk_w] bool: condensed columns that at least one edge lands in."""
    tiles = np.asarray(meta.a_tiles[s])
    return (tiles != 0).any(axis=1).reshape(-1)


@pytest.mark.parametrize("seed", [3, 11])
def test_col_ids_ext_remap_matches_global_gather(seed):
    """Host-simulated exchange: ext-slab gather == global gather on every
    column a real edge references (padding columns are zero-tiled)."""
    rng = np.random.default_rng(seed)
    n = 220
    deg = rng.poisson(5, n).clip(0, n - 1)
    cols_l = [np.unique(rng.integers(0, n, d)) for d in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols_l], out=ptr[1:])
    ptr, cols = ptr.astype(np.int32), np.concatenate(cols_l).astype(np.int32)

    G = 4
    fwd, _ = partition_graph(ptr, cols, n, G, CFG)
    rows = fwd.rows_per_shard
    x = rng.standard_normal((fwd.padded_nodes, 8)).astype(np.float32)

    # Simulate the per-offset ppermutes: for each offset o, shard s
    # receives from owner t=(s+o)%G the cap_o-wide segment of t's send
    # table (parallel/graph.halo_exchange's exact data flow).
    send_idx = fwd.halo["send_idx"]
    caps = fwd.halo["offset_caps"]
    for s in range(G):
        segs, pos = [], 0
        for o, cap in caps:
            t = (s + o) % G
            segs.append(x[t * rows + send_idx[t, pos : pos + cap]])
            pos += cap
        ext = np.concatenate([x[s * rows : (s + 1) * rows]] + segs)
        mask = _real_col_mask(fwd, s)
        got = ext[fwd.halo["col_ids_ext"][s]][mask]
        want = x[fwd.col_ids[s]][mask]
        np.testing.assert_array_equal(got, want)


def test_overlap_remote_col_ids_ext_in_range():
    ptr, cols = banded_csr(600, 4)
    fwd, _ = partition_graph(ptr, cols, 600, 4, CFG)
    ext_rows = fwd.rows_per_shard + fwd.halo["halo_rows"]
    ov = fwd.halo["overlap_remote_col_ids_ext"]
    assert ov.min() >= 0 and ov.max() < ext_rows


def test_plan_halo_rounds_schedule_properties():
    """Quantized partial-pair rounds: coverage, monotone positions, wire
    within the budget, heavy-requester pairs ride extra rounds alone."""
    import numpy as np

    from tcgnn.parallel.partition import plan_halo_rounds

    G = 6
    rng = np.random.default_rng(0)
    pc = rng.integers(20, 60, (G, G)).astype(np.int64)
    np.fill_diagonal(pc, 0)
    pc[3, :] = 900  # heavy requester
    pc[3, 3] = 0

    offset_caps, rounds, halo_rows = plan_halo_rounds(pc)
    assert halo_rows == sum(c for _, c in offset_caps)
    # positions tile the halo slab contiguously
    pos = 0
    for p, sz, pairs in rounds:
        assert p == pos or p > 0  # rounds within an offset restart at seg+jq
        assert sz > 0 and len(pairs) >= 1
        pos = max(pos, p + sz)
    assert pos == halo_rows
    # every pair's rows are fully covered by its rounds
    seg = {}
    run = 0
    for o, c in offset_caps:
        seg[o] = run
        run += c
    for o, cap in offset_caps:
        for s in range(G):
            need = int(pc[s][(s + o) % G])
            got = sum(
                min(sz, max(0, need - (p - seg[o])))
                for p, sz, pairs in rounds
                if seg[o] <= p < seg[o] + cap
                and ((s + o) % G, s) in pairs
            )
            assert got >= need, (o, s, got, need)
    # scheduled wire within the planner's own budget
    wire = sum(sz * len(pairs) for _, sz, pairs in rounds)
    ideal = int(pc.sum())
    n_pairs = int((pc > 0).sum())
    assert wire <= 1.25 * ideal + 64 * n_pairs
    # light pairs do NOT ride the heavy requester's deep rounds
    deep = [r for r in rounds if len(r[2]) == 1]
    assert deep, "heavy requester should get solo rounds"
