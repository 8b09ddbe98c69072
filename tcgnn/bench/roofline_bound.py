"""Per-graph HBM-bytes bound of the SpMM and the GCN epoch.

For each graph, the bytes the shipped data layout must move per SpMM, over
the device's published HBM bandwidth (``utils.profiling.PEAKS``), is the
least time any implementation of that layout can take.  Given measured
times (the ``--single_kernel`` and GCN sweeps' CSVs) the tool reports the
measured/bound ratio; a ratio near 1 means the op sits on its memory bound.

Bytes per SpMM at width d (bf16 features, int8 structural tiles):

  condensed (dense-tile) route:
    tiles (B * blk_h * blk_w) + gathered rows (B * blk_w * d * 2)
    + output (W * blk_h * d * 2)
  block-diagonal route:
    pack (Bp * bn * K*bn) + halo stack (Bp * K*bn * d * 2, written and
    read) + output (Bp * bn * d * 2)

Usage (host-only; the device kind names the peak used):
    python -m tcgnn.bench.roofline_bound --device_kind "NVIDIA H100 80GB HBM3" \\
        --single_kernel_csv 2_tcgnn_single_kernel.csv \\
        --gcn_csv 1_bench_gcn.csv --out roofline.csv
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

BF16 = 2
BD_GROUP = 8                # ops.spmm.BD_BIN_GROUP


def spmm_bytes(graph, bdm, d, cfg):
    """Bytes one SpMM at width ``d`` must move on ``graph``'s route."""
    if bdm is not None:
        bp = -(-bdm.num_bins // BD_GROUP) * BD_GROUP
        bn = bdm.bin_rows
        kw = len(bdm.offsets) * bn
        return bp * bn * kw + 2 * bp * kw * d * BF16 + bp * bn * d * BF16
    meta = graph.meta
    return (
        int(meta.num_blocks) * cfg.blk_h * cfg.blk_w
        + int(meta.col_ids.shape[0]) * d * BF16
        + int(meta.num_windows) * cfg.blk_h * d * BF16
    )


def epoch_bytes(graph, bdm, d_in, hidden, cfg, n):
    """2-layer GCN no-hoist epoch: 4 SpMMs plus the dense layers' traffic.

    The input-width activations are touched ~3x (layer-1 matmul forward
    and its backward reads), the hidden-width ones ~8x (relu, dropout,
    matmuls, log-softmax forward and backward); Adam's parameters are
    negligible.
    """
    s1 = spmm_bytes(graph, bdm, d_in, cfg)
    s2 = spmm_bytes(graph, bdm, hidden, cfg)
    return 2 * s1 + 2 * s2 + (3 * d_in + 8 * hidden) * n * BF16


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device_kind", required=True,
                   help="jax device_kind whose published peaks to use")
    p.add_argument("--single_kernel_csv", required=True)
    p.add_argument("--gcn_csv", required=True)
    p.add_argument("--datasets", nargs="*", default=None)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    from tcgnn.bench.datasets import AE_TABLE
    from tcgnn.config import TileConfig
    from tcgnn.data import synthetic
    from tcgnn.graph import TiledGraph
    from tcgnn.sgt import blockdiag as bd
    from tcgnn.sgt.reorder import reorder_dataset
    from tcgnn.utils.profiling import device_peaks

    hbm_bps = device_peaks(args.device_kind)["hbm_gb_per_s"] * 1e9

    def read_csv(path, key_col, val_col):
        out = {}
        if os.path.exists(path):
            with open(path) as f:
                for row in csv.DictReader(f):
                    try:
                        out[row[key_col]] = float(row[val_col])
                    except (KeyError, ValueError):
                        pass
        return out

    sag = read_csv(args.single_kernel_csv, "dataset", "SAG avg (ms)")
    gcn = read_csv(args.gcn_csv, "dataset", "Avg.Epoch (ms)")

    table = [
        (n, d, c) for n, d, c in AE_TABLE
        if args.datasets is None or n in args.datasets
    ]
    with open(args.out, "w") as f:
        f.write(
            "dataset,path,spmm_bound_ms_d96,sag_measured_ms,sag_vs_bound,"
            "epoch_bound_ms,epoch_measured_ms,epoch_vs_bound\n"
        )
        for name, dim, classes in table:
            ds = synthetic.synthesize(name, dim, classes)
            reorder_dataset(ds, "rcm")
            cfg = TileConfig(blk_h=512, blk_w=128, edge_chunk=128)
            g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, cfg)
            bdm = (
                bd.extract_block_diag(
                    ds.row_pointers, ds.column_index, ds.num_nodes
                )
                if g.block_diag
                else None
            )
            b96 = spmm_bytes(g, bdm, 96, cfg) / hbm_bps * 1e3
            eb = epoch_bytes(g, bdm, dim, 16, cfg, ds.num_nodes) / hbm_bps * 1e3
            sm = sag.get(name)
            em = gcn.get(name)
            f.write(
                f"{name},{'bd' if bdm is not None else 'condensed'},"
                f"{b96:.4f},"
                f"{'' if sm is None else f'{sm:.4f}'},"
                f"{'' if sm is None else f'{sm / b96:.2f}'},"
                f"{eb:.4f},"
                f"{'' if em is None else f'{em:.4f}'},"
                f"{'' if em is None else f'{em / eb:.2f}'}\n"
            )
            f.flush()
            print(f"{name} done", flush=True)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
