"""Block-diagonal / block-banded fast path: SpMM as a plain batched matmul.

On the low-degree AE graphs (OVCAR-8H, Yeast, DD — molecule/protein
collections, avg degree ~2-5) the condensed design spends most of its time
gathering individual neighbour rows.  But these graphs are unions of tiny
connected components: after
RCM every component is a contiguous run of node ids with bandwidth far below
128, so with 128-row bins every edge lands in a block at offset -1/0/+1 from
the diagonal.  The whole SpMM then collapses to (at most three) *uniform
batched 128x128 matmuls*:

    y[b] = sum_k  D_k[b] @ x[b + k]          (k in the selected offsets)

— no per-row gather, purely sequential memory streams.  (Not yet measured
against the condensed route on the H100.)

Offsets are selected adaptively: a diagonal is materialized only when it
carries a meaningful share of edges; everything else goes to a *residual*
edge set served by the condensed-gather route (empty on molecule
graphs, small after RCM elsewhere).  The path auto-disables below a coverage
threshold so power-law graphs keep the condensed design.

This replaces the role of the reference's neighbor-gather into shared memory
(/root/reference/TCGNN_conv/TCGNN_kernel.cu:399-427) for banded graphs with
alignment instead of gather.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# A diagonal offset is materialized as dense [B, bin, bin] tiles only when it
# carries at least this share of the edges (below that, the residual gather
# path is cheaper than streaming a full mostly-zero tile array).
MIN_OFFSET_SHARE = 0.02
# The block-diagonal path activates only when the selected offsets cover at
# least this fraction of edges.
MIN_COVERAGE = 0.85
# Never materialize more than this many bytes of int8 diagonal tiles.
BD_TILE_BUDGET_BYTES = 6 << 30
# Auto offset selection (candidate_offsets=None): a diagonal's tile stream
# costs one [B, bin, bin] int8 read per SpMM (~bin^2 bytes per bin, ~20 ns
# at HBM rate), while an edge left to the residual path costs roughly one
# condensed-gather row (~2.2 ns at the measured 0.45 G rows/s).  Break-even
# is therefore ~8 covered edges per bin — below that, streaming a
# mostly-zero diagonal is slower than gathering its edges.
PAYOFF_EDGES_PER_BIN = 8
# Cap on materialized diagonal streams (bounds HBM traffic and roll count).
MAX_BD_OFFSETS = 8


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass
class BDMeta:
    """Host-side block-diagonal decomposition of a CSR adjacency."""

    bin_rows: int                 # block size (128)
    num_bins: int                 # B = ceil(N / bin_rows)
    offsets: tuple                # selected diagonal offsets, e.g. (0, -1, 1)
    # Sparse tile contents: unique flat indices into the [K*B*bin*bin] tile
    # array and their duplicate-edge counts.  The dense array is built ON
    # DEVICE from these (ops/spmm.build_bd_pack) instead of materializing,
    # packing and uploading hundreds of MB of mostly-zero int8 from the
    # host.
    tile_idx: np.ndarray          # [nnz] int64, sorted
    tile_cnt: np.ndarray          # [nnz] int8 (int16 on overflow)
    coverage: float               # edge fraction covered by `offsets`
    # Residual edges (outside the selected offsets), as a CSR over the same
    # node set; None when fully covered.
    res_ptr: Optional[np.ndarray]
    res_idx: Optional[np.ndarray]
    res_edge_ids: Optional[np.ndarray]  # positions of residual edges in CSR order
    # For the weighted path: per-edge scatter targets into the flat tile
    # array (covered edges only), aligned with `cov_edge_ids`.
    cov_edge_ids: np.ndarray      # positions of covered edges in CSR order
    cov_flat_idx: np.ndarray      # flat index into tiles[K*B*bin*bin]
    # Native-pass precomputed packed_cov_idx (None on the numpy path).
    cov_pack_idx: Optional[np.ndarray] = None

    def packed_cov_idx(self) -> np.ndarray:
        """``cov_flat_idx`` ([K, B, bin, bin] layout) re-addressed into the
        kernel's packed [Bp, bin, K*bin] layout (``ops.spmm.build_bd_pack``)
        so per-edge weights/scores scatter/gather straight against the pack.
        Row-major in (b, r, k, c); independent of the Bp bin padding."""
        if self.cov_pack_idx is not None:
            return self.cov_pack_idx  # emitted by the native fill pass
        bn, nb, k = self.bin_rows, self.num_bins, len(self.offsets)
        bnbn = bn * bn
        ki, rem = np.divmod(self.cov_flat_idx, nb * bnbn)
        b, rc = np.divmod(rem, bnbn)
        r, c = np.divmod(rc, bn)
        return (b * bn + r) * (k * bn) + ki * bn + c

    def dense_tiles(self) -> np.ndarray:
        """Materialize the [K, B, bin, bin] tile array (tests/analytics)."""
        k = len(self.offsets)
        t = np.zeros(
            k * self.num_bins * self.bin_rows * self.bin_rows,
            self.tile_cnt.dtype,
        )
        t[self.tile_idx] = self.tile_cnt
        return t.reshape(k, self.num_bins, self.bin_rows, self.bin_rows)


def bd_edge_offsets(row_pointers, column_index, bin_rows: int = 128):
    """Per-edge block offset (col_bin - row_bin) and row ids; cheap."""
    ptr = np.asarray(row_pointers, dtype=np.int64)
    cols = np.asarray(column_index, dtype=np.int64)
    n = len(ptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    return rows, cols, (cols // bin_rows) - (rows // bin_rows)


def bd_coverage(row_pointers, column_index, bin_rows: int = 128,
                candidate_offsets=(0, -1, 1)) -> float:
    """Edge fraction within the candidate diagonals (gating pre-check)."""
    cols = np.asarray(column_index)
    if len(cols) == 0:
        return 1.0
    _, _, off = bd_edge_offsets(row_pointers, column_index, bin_rows)
    return float(np.isin(off, candidate_offsets).mean())


def extract_block_diag(
    row_pointers,
    column_index,
    num_nodes: int,
    bin_rows: int = 128,
    candidate_offsets=None,
    min_offset_share: float = MIN_OFFSET_SHARE,
    min_coverage: float = MIN_COVERAGE,
) -> Optional[BDMeta]:
    """Decompose A into dense diagonal-block tiles + a residual CSR.

    ``candidate_offsets=None`` selects diagonals from the edge-offset
    histogram: all of them when there are at most ``MAX_BD_OFFSETS``
    distinct offsets (component unions — full coverage, no residual
    dispatch), otherwise the top offsets whose edge count pays for their
    own tile stream (``PAYOFF_EDGES_PER_BIN``; DD-class banded graphs pick
    up +-2 this way and drop their residual from 10% to <2% of edges).

    Returns None when the selected offsets cover less than ``min_coverage``
    of the edges or the tile array would blow the budget (caller falls back
    to the condensed-gather path).
    """
    ptr = np.ascontiguousarray(row_pointers, dtype=np.int64)
    cols_i32 = np.ascontiguousarray(column_index, dtype=np.int32)
    n = int(num_nodes)
    e = len(cols_i32)
    nbins = max(_cdiv(n, bin_rows), 1)
    if e == 0:
        return None

    # Offset histogram: one native OpenMP pass when the library is
    # available (sgt.cpp:sgt_bd_hist); otherwise the numpy edge-offset
    # scan.  Both yield np.unique(off, return_counts=True) semantics.
    from tcgnn.sgt import native

    use_native = native.available()
    if use_native:
        vals, cnts = native.bd_hist(ptr, cols_i32, bin_rows, nbins)
        off = None
    else:
        rows, cols, off = bd_edge_offsets(ptr, cols_i32, bin_rows)
        vals, cnts = np.unique(off, return_counts=True)
    cnt_of = dict(zip(vals.tolist(), cnts.tolist()))

    if candidate_offsets is None:
        if len(vals) <= MAX_BD_OFFSETS:
            candidate_offsets = tuple(int(v) for v in vals)
        else:
            pay = cnts >= max(64, PAYOFF_EDGES_PER_BIN * nbins)
            order = np.argsort(-cnts[pay], kind="stable")
            candidate_offsets = tuple(
                int(v) for v in vals[pay][order][:MAX_BD_OFFSETS]
            )
        # The count gate above already priced each stream; the share
        # threshold below is for explicitly supplied candidate sets.
        min_offset_share = 0.0
        if not candidate_offsets:
            return None

    # Adaptive offset selection: keep a diagonal only when it pays for its
    # own tile stream.  Offset 0 is always kept if present (it anchors the
    # banded structure; without it coverage can't pass the gate anyway).
    counts = {k: cnt_of.get(k, 0) for k in candidate_offsets}
    if sum(counts.values()) == e:
        # Keeping every non-empty candidate makes the residual empty; skipping
        # the residual SpMM dispatch entirely beats saving a thin diagonal
        # stream, so ignore the per-offset share threshold in that case.
        offsets = tuple(k for k in candidate_offsets if counts[k] > 0)
    else:
        offsets = tuple(
            k for k in candidate_offsets
            if counts[k] >= max(1, int(min_offset_share * e))
        )
    if not offsets:
        return None
    # Sorted offsets let the op treat a contiguous offset range as ONE
    # wide contraction (tiles packed side-by-side multiply a vertical
    # stack of adjacent x bins) instead of K narrow dots.
    offsets = tuple(sorted(offsets))
    num_cov = sum(counts[k] for k in offsets)
    coverage = num_cov / e
    if coverage < min_coverage:
        return None
    if len(offsets) * nbins * bin_rows * bin_rows > BD_TILE_BUDGET_BYTES:
        return None

    if use_native:
        # One counting + one writing OpenMP pass (sgt.cpp:sgt_bd_fill):
        # covered/residual streams in CSR edge order, plus sorted unique
        # tile indices from a linear per-offset-segment dedup (the flat
        # layout is k-major, so no comparison sort is needed).
        (cov_flat, cov_eid, cov_pack, uniq, cnt_i32,
         res_counts, res_idx, res_eid) = native.bd_fill(
            ptr, cols_i32, bin_rows, nbins, offsets,
            [counts[k] for k in offsets], e - num_cov,
        )
        dtype = np.int8 if (len(cnt_i32) == 0 or cnt_i32.max() <= 127) else np.int16
        if coverage < 1.0:
            res_ptr = np.cumsum(res_counts, dtype=np.int64).astype(np.int32)
            res = (res_ptr, res_idx, res_eid)
        else:
            res = (None, None, None)
        return BDMeta(
            bin_rows=bin_rows,
            num_bins=nbins,
            offsets=offsets,
            tile_idx=uniq,
            tile_cnt=cnt_i32.astype(dtype),
            coverage=coverage,
            res_ptr=res[0],
            res_idx=res[1],
            res_edge_ids=res[2],
            cov_edge_ids=cov_eid,
            cov_flat_idx=cov_flat,
            cov_pack_idx=cov_pack,
        )

    covered = np.isin(off, offsets)
    coverage = float(covered.mean())

    # Duplicate-edge counts via sorted-run lengths (CSR rows/cols are sorted,
    # so equal flat indices are adjacent within an offset class; np.unique
    # handles stragglers) — much faster than np.add.at.
    k_of = np.full(len(off), -1, dtype=np.int64)
    for i, k in enumerate(offsets):
        k_of[off == k] = i
    bi = rows // bin_rows
    flat = (
        (k_of * nbins + bi) * (bin_rows * bin_rows)
        + (rows % bin_rows) * bin_rows
        + (cols - (bi + np.where(covered, off, 0)) * bin_rows)
    )[covered]
    uniq, cnt = np.unique(flat, return_counts=True)
    dtype = np.int8 if (len(cnt) == 0 or cnt.max() <= 127) else np.int16

    edge_ids = np.arange(e, dtype=np.int64)
    cov_edge_ids = edge_ids[covered]
    if coverage < 1.0:
        res_rows = rows[~covered]
        res_idx = cols[~covered].astype(np.int32)
        res_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(res_rows, minlength=n), out=res_ptr[1:])
        res = (res_ptr.astype(np.int32), res_idx, edge_ids[~covered])
    else:
        res = (None, None, None)

    return BDMeta(
        bin_rows=bin_rows,
        num_bins=nbins,
        offsets=offsets,
        tile_idx=uniq,
        tile_cnt=cnt.astype(dtype),
        coverage=coverage,
        res_ptr=res[0],
        res_idx=res[1],
        res_edge_ids=res[2],
        cov_edge_ids=cov_edge_ids,
        cov_flat_idx=flat,
    )
