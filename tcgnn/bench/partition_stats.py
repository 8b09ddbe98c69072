"""Measured partition statistics for the distributed layer.

For a window-aligned row partition over G shards this counts what the
distributed ops execute and move — no times:

* per-shard boundary sizes (the exact rows the boundary-only halo exchange
  moves — ``parallel/partition.build_halo`` semantics) and the wire rows of
  the quantized ``ppermute`` rounds (``partition.plan_halo_rounds``);
* per-shard SGT block counts and the compute balance they imply, with and
  without the mega-window block-stream split.

Turning these counts into times needs the card's measured collective and
kernel rates (ROADMAP A8); none are modelled here.

Run (host-only, no devices needed):
  python -m tcgnn.bench.partition_stats --datasets amazon0601 reddit \
      --shards 2 4 8 --dim 16 --csv partition_stats.csv
"""

from __future__ import annotations

import argparse
import csv
import sys

import numpy as np

from tcgnn.config import DEFAULT_CONFIG, TileConfig
from tcgnn.sgt.translate import _cdiv, _pad_blocks  # window math shared with the partitioner

BF16 = 2  # bytes


def shard_stats(row_pointers, column_index, num_nodes, num_shards,
                config: TileConfig = DEFAULT_CONFIG):
    """Measured per-shard stats for a window-aligned 1-D row partition.

    Uses the same shard geometry as ``parallel/partition.partition_csr``
    (windows never cross shards) and the native SGT counter, so the block
    counts match what the distributed ops actually execute.
    """
    from tcgnn.sgt import native

    blk_h = config.blk_h
    ptr = np.asarray(row_pointers, np.int64)
    cols = np.asarray(column_index, np.int64)
    num_windows = max(_cdiv(num_nodes, blk_h), 1)
    wd = _cdiv(num_windows, num_shards)
    rows_per_shard = wd * blk_h
    n_pad = num_shards * rows_per_shard
    ptr = np.concatenate([ptr, np.full(n_pad + 1 - len(ptr), ptr[-1], np.int64)])

    shards = []
    for s in range(num_shards):
        r0, r1 = s * rows_per_shard, (s + 1) * rows_per_shard
        local_ptr = np.ascontiguousarray(ptr[r0:r1 + 1] - ptr[r0])
        local_cols = cols[ptr[r0]:ptr[r1]]
        uniq = np.unique(local_cols)
        remote = uniq[(uniq < r0) | (uniq >= r1)]
        boundary = int(len(remote))
        # Per-owner request counts — the per-offset ppermute halo pads
        # each owner-offset collective to that offset's max pair count
        # (partition.build_halo offset_caps); count_summary derives the
        # wire volume from these counts.  Measured-vs-model
        # reconciliation lives in bench/measure_comm.py.
        pair_row = np.bincount(
            remote // rows_per_shard, minlength=num_shards
        ).astype(np.int64)
        if native.available():
            per_win = native.count_blocks(
                local_ptr, np.ascontiguousarray(local_cols, np.int32),
                blk_h, config.blk_w,
            )
        else:  # pragma: no cover - native pass is always built in-tree
            from tcgnn.sgt.translate import sparse_graph_translate
            per_win = sparse_graph_translate(
                local_ptr, local_cols, rows_per_shard, config,
                emit_chunks=False, build_tiles=False,
            ).block_partition
        blocks = int(_pad_blocks(np.asarray(per_win, np.int64), config).sum())
        shards.append(dict(edges=int(len(local_cols)), boundary=boundary,
                           blocks=blocks, pair_row=pair_row))
    return rows_per_shard, shards


def count_summary(shards, dim):
    """Balance and halo volume implied by the measured shard counts."""
    from tcgnn.parallel.partition import plan_halo_rounds

    g = len(shards)
    pair_counts = [list(map(int, s["pair_row"])) for s in shards]
    _, rounds, _ = plan_halo_rounds(pair_counts)
    # Per-device average rows on the wire over the ppermute rounds.
    wire_rows = sum(sz * len(pairs) for _, sz, pairs in rounds) / max(g, 1)
    total_blocks = sum(x["blocks"] for x in shards)
    mean = total_blocks / g
    balance = mean / max(max(x["blocks"] for x in shards), 1)
    # With the mega-window block-stream split (partition.build_split) the
    # stacked grid shrinks to ~ideal + 5% slack regardless of hub windows;
    # the split gates on measured imbalance, so it never makes things worse.
    ideal = -(-total_blocks // g)
    balance_split = mean / (ideal + max(ideal // 20, 1))
    return dict(
        balance=balance,
        balance_split=max(balance, balance_split),
        halo_wire_rows=wire_rows,
        halo_wire_bytes=wire_rows * max(dim, 8) * BF16,
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datasets", nargs="+", default=["amazon0601"])
    p.add_argument("--shards", nargs="+", type=int, default=[2, 4, 8])
    p.add_argument("--dim", type=int, default=16,
                   help="feature width of the hot SpMM (GCN hidden=16)")
    p.add_argument("--reorder", default="rcm", choices=["none", "rcm", "community"])
    p.add_argument("--balance", action="store_true",
                   help="apply the window-granular LPT shard balance "
                   "(what --mesh training does on non-BD graphs) before "
                   "measuring")
    p.add_argument("--data_dir", default="tcgnn-ae-graphs/")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)

    from tcgnn import train as train_lib

    rows_out = []
    for name in args.datasets:
        targs = train_lib.build_argparser().parse_args(
            ["--dataset", name, "--dim", str(args.dim), "--classes", "2"]
        )
        ds = train_lib.load_dataset(targs)
        if args.reorder != "none":
            from tcgnn.sgt.reorder import reorder_dataset

            reorder_dataset(ds, args.reorder)
        for g in args.shards:
            if args.balance:
                import copy

                from tcgnn.sgt.reorder import balance_dataset

                dsg = copy.copy(ds)  # balance is G-specific; keep ds pristine
                balance_dataset(dsg, g)
            else:
                dsg = ds
            rps, shards = shard_stats(
                dsg.row_pointers, dsg.column_index, dsg.num_nodes, g
            )
            r = count_summary(shards, args.dim)
            bmax = max(s["boundary"] for s in shards)
            row = dict(
                dataset=name, shards=g, nodes=ds.num_nodes,
                edges=ds.num_edges, rows_per_shard=rps,
                boundary_max=bmax,
                boundary_frac=round(bmax / max(ds.num_nodes, 1), 4),
                halo_kb=round(bmax * max(args.dim, 8) * BF16 / 1024, 1),
                blocks_balance=round(r["balance"], 3),
                blocks_balance_split=round(r["balance_split"], 3),
                halo_wire_kb=round(r["halo_wire_bytes"] / 1024, 1),
            )
            rows_out.append(row)
            print(" ".join(f"{k}={v}" for k, v in row.items()))

    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows_out[0]))
            w.writeheader()
            w.writerows(rows_out)
        print(f"# wrote {args.csv}")


if __name__ == "__main__":
    sys.exit(main())
