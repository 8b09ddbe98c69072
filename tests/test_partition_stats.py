"""bench.partition_stats: measured shard stats and the counts they imply."""

import numpy as np

from tcgnn.bench.partition_stats import count_summary, shard_stats
from tcgnn.config import TileConfig


def test_shard_stats_and_roofline():
    rng = np.random.default_rng(0)
    n = 2000
    deg = rng.poisson(5, n).clip(0, n - 1)
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    cfg = TileConfig(blk_h=128, blk_w=128)
    rps, shards = shard_stats(ptr.astype(np.int32),
                              np.concatenate(cols).astype(np.int32), n, 4, cfg)
    assert len(shards) == 4 and rps * 4 >= n
    assert sum(s["edges"] for s in shards) == int(ptr[-1])
    for s in shards:
        assert 0 <= s["boundary"] <= n
        assert s["blocks"] >= rps // cfg.blk_h  # >=1 padded block per window
    r = count_summary(shards, dim=16)
    assert 0 < r["balance"] <= r["balance_split"] <= 1
    assert r["halo_wire_rows"] >= 0
    assert r["halo_wire_bytes"] == r["halo_wire_rows"] * 16 * 2
