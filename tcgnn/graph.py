"""TiledGraph: an SGT-tiled graph with differentiable aggregation ops.

This is the framework's equivalent of the reference's L1/L2 stack — the
pybind11 op registry (``/root/reference/TCGNN_conv/TCGNN.cpp:260-272``) plus
the ``torch.autograd.Function`` wrappers (``gnn_conv.py:26-158``) — folded
into one object: it owns the forward *and transpose* SGT metadata and
exposes ``custom_vjp``-wrapped ops.

Differences from the reference, on purpose:

* the reference aliases ``backward`` to the forward SpMM, assuming a
  symmetric adjacency (TCGNN.cpp:270); we carry explicit transpose-graph
  metadata so gradients are exact on directed graphs (and skip the extra
  tiling when the caller declares symmetry);
* the weighted-SpMM backward computes the exact per-edge weight gradient
  ``dw_e = <dY[row_e], X[col_e]>`` via the two-matrix SDDMM, instead of the
  reference AGNN backward's ad-hoc ``d_att @ column_index`` estimate
  (gnn_conv.py:150-158).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tcgnn.config import DEFAULT_CONFIG, TileConfig
from tcgnn.ops.sddmm import (
    sddmm_tc,
    sddmm_tc_dense,
    sddmm_tc_streamed,
)
from tcgnn.ops.spmm import (
    bd_scatter_weights,
    bd_sddmm_edges,
    bd_sfused,
    bd_sfused_bwd,
    build_a_tiles,
    build_bd_pack,
    build_struct_tiles,
    spmm_block_diag,
    spmm_sfused,
    spmm_sfused_bwd,
    spmm_tc,
    spmm_tc_dense,
    spmm_tc_streamed,
)
from tcgnn.sgt.blockdiag import extract_block_diag
from tcgnn.sgt.stream import needs_streaming, segment_chunks
from tcgnn.sgt.translate import (
    build_a_tiles_host,
    count_blocks,
    sparse_graph_translate,
    transpose_csr,
)

# Route thresholds.  The values were carried over from an earlier
# accelerator and are not measured on the H100; re-deriving them from a
# sweep on the card is ROADMAP item A4.
#
# Above this many dense-tile bytes (fwd + transpose structural tiles) the
# graph falls back to the memory-lean chunk form.
DENSE_TILE_BUDGET_BYTES = 8 << 30

# Structural tile arrays at or below this size are built host-side (fused
# into the translate pass) and shipped as one async upload; larger arrays
# are scatter-built on device from the 4-byte/edge flat positions.
HOST_TILE_BUILD_LIMIT = 64 << 20

# Above this many f32 score-tile bytes, the condensed SDDMM skips the
# score-tile materialization entirely and computes the per-edge dots
# directly: 2E row gathers from the small [N, d] operands instead of
# writing, then reading back, a multi-GB tile array (hub graphs).
SDDMM_EDGE_DOT_BYTES = 512 << 20


def _round_up_int(x: int, m: int) -> int:
    return -(-x // m) * m


def _auto_block_group(row_pointers, column_index, config):
    """Resolve ``block_group=0``: 2 for block-dense windows, else 1.

    Returns ``(group, per_window_counts)`` — the counting pass is the
    dominant host cost on small graphs (~9 ms on pubmed), so the counts
    are handed back for the dense-vs-chunk gate to reuse."""
    from tcgnn.sgt import native

    n_rows = len(row_pointers) - 1
    if n_rows <= 0 or len(column_index) == 0 or not native.available():
        return 1, None
    per_win = native.count_blocks(
        np.ascontiguousarray(row_pointers, np.int64),
        np.ascontiguousarray(column_index, np.int32),
        config.blk_h, config.blk_w,
    )
    avg = float(np.maximum(per_win, 1).mean())
    return (2 if avg >= 8.0 else 1), per_win


class TiledGraph:
    """Device-resident SGT-tiled graph.

    Build once per graph (the reference's ``Prep. (ms)`` stage,
    main_tcgnn.py:50-54); reuse across layers/epochs.
    """

    def __init__(
        self,
        row_pointers: np.ndarray,
        column_index: np.ndarray,
        num_nodes: Optional[int] = None,
        config: TileConfig = DEFAULT_CONFIG,
        symmetric: bool = False,
        dense_tiles: Optional[bool] = None,
        block_diag: Optional[bool] = None,
        streamed: Optional[bool] = None,
        weighted_traffic: bool = False,
        stream_segments: Optional[int] = None,
    ):
        row_pointers = np.asarray(row_pointers)
        column_index = np.asarray(column_index)
        if num_nodes is None:
            num_nodes = len(row_pointers) - 1
        self.num_nodes = int(num_nodes)
        self.num_edges = int(len(column_index))
        # Host-pass seconds (SGT counting/translation/transpose/BD
        # extraction — no device placement): the reference's "Prep." times
        # ONLY its C++ pass (main_tcgnn.py:54); the metadata .cuda() moves
        # at :56-60 sit OUTSIDE its timer.  The trainer reports this
        # alongside the full build time for a like-for-like comparison.
        self.prep_host_s = 0.0
        _t0 = time.perf_counter()
        per_win_f = None
        if config.block_group == 0:
            # AUTO group: one cheap native count pass decides whether SGT
            # pads each window's block count to pairs (block-dense windows)
            # or not (sparse windows, where group padding inflates the
            # condensed gather).  The rule is not measured on the H100
            # (ROADMAP A4).  The counts feed the dense-vs-chunk gate below
            # too — one pass, not two.
            group, per_win_f = _auto_block_group(
                row_pointers, column_index, config
            )
            config = dataclasses.replace(config, block_group=group)
        self.config = config
        self.prep_host_s += time.perf_counter() - _t0
        self.symmetric = symmetric

        # Transpose CSR up front: structure can be shared when the adjacency
        # is symmetric (skipping a second tiling pass and tile upload), but
        # the per-edge permutation is always needed — edge *weights* live in
        # CSR edge order, and aggregating along A^T needs them in transpose
        # order even when the structure is symmetric.  Symmetry is
        # auto-detected by comparing the transpose CSR (cheap array
        # equality); all the reference AE graphs are symmetrized.
        _t0 = time.perf_counter()
        t_ptr, t_idx, t_src = transpose_csr(row_pointers, column_index, num_nodes)
        self.prep_host_s += time.perf_counter() - _t0
        self._t_edge_src = jnp.asarray(t_src)
        _t0 = time.perf_counter()
        if not symmetric and len(t_ptr) == len(row_pointers):
            symmetric = bool(
                np.array_equal(np.asarray(t_ptr, np.int64), np.asarray(row_pointers, np.int64))
                and np.array_equal(np.asarray(t_idx, np.int64), np.asarray(column_index, np.int64))
            )
        self.symmetric = symmetric

        # Dense-tile fast path: materialize the SGT-condensed A-tiles as
        # dense [B, blk_h, blk_w] blocks (exactly the format whose footprint
        # the reference reports as `Exp_Edges`, TCGNN.cpp:225) so SpMM/SDDMM
        # are pure block matmuls.  Auto-off when it would blow the budget or
        # the flat index space overflows int32.  The cheap count pass decides
        # before the full translation runs.
        tile_elems = config.blk_h * config.blk_w
        nb_f = count_blocks(
            row_pointers, column_index, num_nodes, config,
            per_window=per_win_f,
        )
        nb_t = nb_f if symmetric else count_blocks(t_ptr, t_idx, num_nodes, config)
        self.prep_host_s += time.perf_counter() - _t0
        fits_int32 = max(nb_f, nb_t) * tile_elems < 2**31
        # Structural tiles are int8 and shared when symmetric.
        dense_bytes = (nb_f if symmetric else nb_f + nb_t) * tile_elems
        self._bdm_probe = None  # pre-extracted BD decomposition (reused below)
        itemsize = jnp.dtype(config.compute_dtype).itemsize
        if weighted_traffic and not symmetric:
            # ASYMMETRIC attention graphs materialize per-layer WEIGHTED
            # tiles at the compute dtype on top of the int8 structural
            # tiles (per-edge weighted path, `build_a_tiles`);
            # forward+backward keep several alive at once, so the dense
            # path must also budget ~4 compute-width tile arrays or the
            # epoch OOMs on big-block graphs.  Symmetric graphs ride the
            # score-fused ops (`spmm_sfused` / `bd_sfused`), whose score
            # tiles are transient within one op and are not budgeted here.
            # The chunk form's weighted SpMM needs only O(E) per-edge
            # scalars — but so does the BLOCK-DIAGONAL weighted path
            # (transient [Bp, bn, K*bn] packs), so probe a BD decomposition
            # before demoting a banded graph to the chunks.
            weighted_extra = 4 * nb_f * tile_elems * itemsize
            if (
                dense_tiles is not False
                and block_diag is not False
                and fits_int32
                and dense_bytes <= DENSE_TILE_BUDGET_BYTES
                and dense_bytes + weighted_extra > DENSE_TILE_BUDGET_BYTES
            ):
                _t0 = time.perf_counter()
                bdm = extract_block_diag(row_pointers, column_index, num_nodes)
                bdm_t = (
                    bdm
                    if (symmetric or bdm is None)
                    else extract_block_diag(t_ptr, t_idx, num_nodes)
                )
                self.prep_host_s += time.perf_counter() - _t0
                if bdm is not None and bdm_t is not None:
                    self._bdm_probe = (bdm, bdm_t)
                    kmax = max(len(bdm.offsets), len(bdm_t.offsets))
                    bd_tile_elems = kmax * bdm.num_bins * bdm.bin_rows**2
                    weighted_extra = 3 * bd_tile_elems * itemsize
            dense_bytes += weighted_extra
        if dense_tiles is None:
            dense_tiles = fits_int32 and dense_bytes <= DENSE_TILE_BUDGET_BYTES
        elif dense_tiles and not fits_int32:
            raise ValueError("dense-tile index space overflows int32 for this graph")
        self.dense_tiles = dense_tiles

        # Host-path graphs (tile bytes under the host_build_limit below)
        # fuse the int8 structural-tile build into the translate pass
        # itself (the native C++ pass emits them near-free), so prep is
        # pure host work + async uploads.
        tile_bytes = config.blk_h * config.blk_w
        host_tiles_f = dense_tiles and nb_f * tile_bytes <= HOST_TILE_BUILD_LIMIT
        host_tiles_t = dense_tiles and nb_t * tile_bytes <= HOST_TILE_BUILD_LIMIT
        _t0 = time.perf_counter()
        host_meta = sparse_graph_translate(
            row_pointers, column_index, num_nodes, config,
            emit_chunks=not dense_tiles, build_tiles=host_tiles_f,
        )
        self.host_meta = host_meta
        if symmetric:
            self.host_meta_t = host_meta
        else:
            self.host_meta_t = sparse_graph_translate(
                t_ptr, t_idx, num_nodes, config,
                emit_chunks=not dense_tiles, build_tiles=host_tiles_t,
            )
        self.prep_host_s += time.perf_counter() - _t0

        # Past the one-shot chunk form's metadata / condensed-row ceilings
        # (Reddit scale), re-lay the chunk metadata as stacked window
        # segments and lax.scan one compiled segment op over them
        # (sgt/stream.py).  The streamed metadata REPLACES the per-graph
        # device metadata entirely — nothing else is uploaded.
        if streamed is None:
            streamed = (not dense_tiles) and (
                needs_streaming(self.host_meta)
                or needs_streaming(self.host_meta_t)
            )
        elif streamed and dense_tiles:
            raise ValueError("streamed chunk path requires dense_tiles=False")
        self.streamed = streamed
        smeta_f = smeta_t = None
        if self.streamed:
            # ``stream_segments`` forces the segment count (a small graph
            # then runs the same multi-segment scan a Reddit-scale one does).
            smeta_f = segment_chunks(self.host_meta, num_segments=stream_segments)
            smeta_t = (
                smeta_f
                if symmetric
                else segment_chunks(self.host_meta_t, num_segments=stream_segments)
            )
        # Condensed device metadata (O(E + B*blk_w) uploads) is deferred
        # until after the block-diagonal probe: a fully-covered addressable
        # BD graph never reads it (same reasoning as the structural tiles
        # below), and the streamed path replaces it entirely.
        self.meta = self.meta_t = None

        self.row_pointers = jnp.asarray(row_pointers.astype(np.int32))
        self.column_index = jnp.asarray(column_index.astype(np.int32))

        if dense_tiles:
            # Structural tiles: NOTHING in this prep stage syncs on the
            # device.  Small/medium tile arrays are built host-side
            # (vectorized bincount) and shipped as one async upload; big
            # arrays are built on the device from the per-edge flat
            # positions (4 bytes/edge) by a single scatter program whose
            # int8 storage cast is fused in — the int8-exactness decision
            # (duplicate-count max <= 127, same rule as the host build)
            # comes from the host translate pass, so prep never fetches a
            # device value.  The scatter compiles per bucketed shape
            # (build_struct_tiles) and lands in the persistent compile
            # cache.
            def to_dev(meta_jax, host_meta):
                small = (
                    host_meta.num_blocks * config.blk_h * config.blk_w
                    <= HOST_TILE_BUILD_LIMIT
                )
                if small or meta_jax.edge_pos is None:
                    tiles = build_a_tiles_host(host_meta)
                    if tiles.max(initial=0.0) <= 127:
                        return jnp.asarray(tiles.astype(np.int8))
                    return jnp.asarray(
                        tiles.astype(jnp.dtype(config.compute_dtype))
                    )
                dt = (
                    jnp.int8
                    if host_meta.max_duplicate_count() <= 127
                    else config.compute_dtype
                )
                return build_struct_tiles(
                    meta_jax.edge_pos,
                    num_blocks=meta_jax.num_blocks,
                    blk_h=config.blk_h,
                    blk_w=config.blk_w,
                    out_dtype=dt,
                )

        else:
            to_dev = None
        # The condensed structural tiles are built AFTER the block-diagonal
        # probe below: a fully-covered BD graph serves every op (unweighted,
        # weighted, SDDMM, fused attention) from the packed diagonal tiles,
        # so the [B, blk_h, blk_w] array (OVCAR-class: 1.2 GB) would be dead
        # device memory + prep time.
        a_struct = a_struct_t = None

        # Block-diagonal fast path (sgt/blockdiag.py): when the (reordered)
        # adjacency is banded/component-structured, the unweighted SpMM runs
        # as uniform batched matmuls — no per-row gather.
        # extract_block_diag returns None below its coverage gate, so plain
        # power-law graphs keep the condensed-gather design automatically.
        self.block_diag = False
        self._bd_offsets = self._bd_offsets_t = None
        self._bd_sddmm_chunks = None
        self._bd_full_coverage = False
        self._bd_addressable = False
        bd_pack_f = bd_pack_t = None
        if dense_tiles and block_diag is not False:
            if self._bdm_probe is not None:
                bdm, bdm_t = self._bdm_probe
            else:
                _t0 = time.perf_counter()
                bdm = extract_block_diag(row_pointers, column_index, num_nodes)
                bdm_t = (
                    bdm
                    if (symmetric or bdm is None)
                    else extract_block_diag(t_ptr, t_idx, num_nodes)
                )
                self.prep_host_s += time.perf_counter() - _t0
            if bdm is not None and bdm_t is not None:
                self.block_diag = True
                self._bd_offsets = bdm.offsets
                self._bd_offsets_t = bdm_t.offsets
                self._bd_full_coverage = (
                    bdm.coverage == 1.0 and bdm_t.coverage == 1.0
                )

                def bd_dev(m, chunked=True):
                    # chunked=False skips the SDDMM chunk metadata (per-edge
                    # pos_pad upload) — the transpose pack never serves
                    # sddmm_f, so asymmetric graphs shouldn't pay it twice.
                    if m.res_ptr is not None:
                        res_host = sparse_graph_translate(
                            m.res_ptr, m.res_idx, self.num_nodes, config,
                            emit_chunks=False, build_tiles=False,
                        )
                        res_meta = res_host.as_jax(lite=True)
                        res_a = to_dev(res_meta, res_host)
                    else:
                        res_meta = res_a = None
                    pack = build_bd_pack(
                        jnp.asarray(m.tile_idx),
                        jnp.asarray(m.tile_cnt),
                        k=len(m.offsets),
                        nbins=m.num_bins,
                        bn=m.bin_rows,
                    )
                    # Per-edge scatter/gather addresses for the weighted /
                    # SDDMM BD ops (packed-layout flat indices + CSR edge
                    # positions).  x64 is disabled, so an index array past
                    # int32 would silently truncate (wraparound scatter
                    # corruption) — such packs mark the per-edge BD ops
                    # unavailable and weighted/SDDMM fall back to the
                    # condensed path instead.
                    pack_elems = (
                        pack.shape[0] * pack.shape[1] * pack.shape[2]
                    )
                    if pack_elems + 1 < 2**31:
                        cov_np = np.asarray(m.packed_cov_idx(), np.int32)
                        cov_pack = jnp.asarray(cov_np)
                    else:
                        cov_np = cov_pack = None
                    if cov_np is not None and chunked:
                        # Per-edge packed positions in CSR edge order for
                        # the chunked BD SDDMM (ops/spmm.bd_sddmm_edges).
                        # Packed positions are non-decreasing along CSR
                        # edge order (bin-major pack, row-major edges), so
                        # each bin-chunk's edges form one contiguous range.
                        # Residual edges carry their predecessor's position
                        # (monotone forward-fill) — their emitted values
                        # are garbage overwritten by the residual scatter.
                        if m.coverage == 1.0:
                            pos_np = cov_np
                        else:
                            pos = np.zeros(self.num_edges, np.int32)
                            pos[m.cov_edge_ids] = cov_np
                            ff = np.zeros(self.num_edges, np.int64)
                            ff[m.cov_edge_ids] = m.cov_edge_ids
                            np.maximum.accumulate(ff, out=ff)
                            pos_np = pos[ff]
                        # Chunk geometry: bins per chunk sized so each
                        # step's xb slab stays ~10 MB, keeping the row
                        # gathers local (not measured on the H100;
                        # ROADMAP A4).
                        kw = len(m.offsets) * m.bin_rows
                        chunk_bins = max(1, (10 << 20) // (kw * 128 * 2))
                        n_chunks = max(1, -(-pack.shape[0] // chunk_bins))
                        chunk_of = pos_np.astype(np.int64) // (
                            kw * chunk_bins * m.bin_rows
                        )
                        e_start_np = np.searchsorted(
                            chunk_of, np.arange(n_chunks)
                        ).astype(np.int32)
                        cap = int(np.max(np.diff(np.append(
                            e_start_np, self.num_edges
                        ))))
                        cap = max(-(-cap // 512) * 512, 512)
                        pos_pad = jnp.asarray(np.concatenate(
                            [pos_np, np.zeros(cap, np.int32)]
                        ))
                        e_start = jnp.asarray(e_start_np)
                        chunk_static = (chunk_bins, n_chunks, cap)
                    else:
                        pos_pad = e_start = None
                        chunk_static = None
                    cov_ids = jnp.asarray(np.asarray(m.cov_edge_ids, np.int32))
                    res_ids = (
                        None
                        if m.res_edge_ids is None
                        else jnp.asarray(np.asarray(m.res_edge_ids, np.int32))
                    )
                    if m.res_ptr is not None and chunked:
                        # Residual (row, col) pairs in residual-CSR order
                        # for the SDDMM's per-edge dots (R is a few % of E,
                        # so two R-row global gathers suffice).  Gated
                        # on `chunked` with the rest of the SDDMM metadata
                        # — the transpose pack never serves sddmm_f.
                        res_rc = (
                            jnp.asarray(np.repeat(
                                np.arange(self.num_nodes, dtype=np.int32),
                                np.diff(m.res_ptr),
                            )),
                            jnp.asarray(np.asarray(m.res_idx, np.int32)),
                        )
                    else:
                        res_rc = None
                    return (
                        pack, res_meta, res_a, cov_pack, cov_ids, res_ids,
                        pos_pad, e_start, res_rc,
                    ), chunk_static

                bd_pack_f, self._bd_sddmm_chunks = bd_dev(bdm)
                bd_pack_t = (
                    bd_pack_f
                    if symmetric
                    else bd_dev(bdm_t, chunked=False)[0]
                )
                self._bd_addressable = (
                    bd_pack_f[3] is not None and bd_pack_t[3] is not None
                )
            elif block_diag:
                raise ValueError(
                    "block_diag requested but coverage is below the gate "
                    "for this graph/ordering"
                )
        needs_condensed = not self.streamed and not (
            self.block_diag and self._bd_full_coverage and self._bd_addressable
        )
        if needs_condensed:
            self.meta = host_meta.as_jax(lite=dense_tiles)
            self.meta_t = (
                self.meta
                if symmetric
                else self.host_meta_t.as_jax(lite=dense_tiles)
            )
        if dense_tiles and needs_condensed:
            a_struct = to_dev(self.meta, self.host_meta)
            a_struct_t = (
                a_struct
                if symmetric
                else to_dev(self.meta_t, self.host_meta_t)
            )

        # Edge-dot SDDMM route for hub graphs (see SDDMM_EDGE_DOT_BYTES):
        # per-edge CSR rows are expanded ON DEVICE at build (repeat over
        # degree counts — async, no extra host upload); cols ride the
        # already-resident column_index.  Both pass through the device
        # arrays so jitted steps carry no multi-MB HLO constants.
        sddmm_ext = None
        self._sddmm_edge_chunk = 0
        if (
            dense_tiles
            and needs_condensed
            and self.num_edges
            and nb_f * tile_elems * 4 > SDDMM_EDGE_DOT_BYTES
            # partial-coverage BD graphs with addressable packs serve
            # SDDMM via bd_sddmm_edges — these arrays would be dead HBM
            and not (self.block_diag and self._bd_addressable)
        ):
            cap = min(1 << 19, _round_up_int(self.num_edges, 512))
            nc = -(-self.num_edges // cap)
            pad = nc * cap - self.num_edges
            ed_rows = jnp.repeat(
                jnp.arange(self.num_nodes, dtype=jnp.int32),
                jnp.diff(self.row_pointers),
                total_repeat_length=self.num_edges,
            )
            ed_rows = jnp.concatenate(
                [ed_rows, jnp.zeros((pad,), jnp.int32)]
            )
            ed_cols = jnp.concatenate(
                [self.column_index, jnp.zeros((pad,), jnp.int32)]
            )
            self._sddmm_edge_chunk = cap
            sddmm_ext = (ed_rows, ed_cols)
        self._device_arrays = (
            self.meta, self.meta_t, a_struct, a_struct_t, self._t_edge_src,
            bd_pack_f, bd_pack_t, smeta_f, smeta_t, sddmm_ext,
        )

        ops = self._make_ops(*self._device_arrays)
        (self.spmm, self.spmm_weighted, self.sddmm, self.agnn_aggregate,
         self.spmm_t) = ops

    # --- statistics (reference's preprocess printout, TCGNN.cpp:225) -------
    @property
    def tc_blocks(self) -> int:
        return self.host_meta.num_real_blocks

    @property
    def exp_edges(self) -> int:
        return self.host_meta.exp_edges

    @property
    def route(self) -> str:
        """Which of ``_make_ops``' routes serves this graph."""
        if self.streamed:
            return "streamed"
        if not self.dense_tiles:
            return "chunk"
        if self.block_diag:
            return "block_diag"
        if self._sddmm_edge_chunk:
            return "dense+edge_dot_sddmm"
        return "dense"

    # --- jit-boundary plumbing ---------------------------------------------
    def arrays(self):
        """Device-array pytree to pass INTO a jitted step (then ``bind``).

        Closing a TiledGraph's ops directly into a jitted training step
        embeds every tile/metadata array as an HLO constant — multi-GB
        programs that are slow to compile and duplicate device memory.
        Pass this pytree as a step argument and rebuild the ops on the
        traced values instead.
        """
        return self._device_arrays

    def bind(self, device_arrays) -> "BoundGraph":
        """Ops namespace over traced array values (inside jit)."""
        return BoundGraph(self, self._make_ops(*device_arrays))

    def _make_ops(
        self, meta, meta_t, a_struct, a_struct_t, t_edge_src,
        bd_pack_f=None, bd_pack_t=None, smeta_f=None, smeta_t=None,
        sddmm_ext=None,
    ):
        n_edges = self.num_edges

        def _edge_dot_sddmm(xa, xb):
            # Hub-graph route: per-edge <xa[row_e], xb[col_e]> from two E-row
            # gathers of the SMALL [N, d] operands — the 2E row-gather
            # bound, skipping the multi-GB score-tile array entirely (see
            # SDDMM_EDGE_DOT_BYTES).  Edges run in chunks of ~0.5M so the
            # gathered rows of one chunk stay a bounded working set; f32
            # products/sums fuse per chunk; contiguous
            # dynamic_update_slice emission, no scatter.
            ed_rows, ed_cols = sddmm_ext  # [nc*cap] padded, sentinel 0
            cap = self._sddmm_edge_chunk
            nc = ed_rows.shape[0] // cap
            ct = self.config.compute_dtype
            a_all = xa.astype(ct)
            b_all = xb.astype(ct)
            out = jnp.zeros((nc * cap,), jnp.float32)

            def body(i, out):
                r = jax.lax.dynamic_slice(ed_rows, (i * cap,), (cap,))
                c = jax.lax.dynamic_slice(ed_cols, (i * cap,), (cap,))
                a = jnp.take(a_all, r, axis=0, fill_value=0)
                b = jnp.take(b_all, c, axis=0, fill_value=0)
                v = jnp.sum(
                    a.astype(jnp.float32) * b.astype(jnp.float32), axis=1
                )
                return jax.lax.dynamic_update_slice(out, v, (i * cap,))

            out = jax.lax.fori_loop(0, nc, body, out)
            return out[:n_edges]

        def to_t(w):
            return w[t_edge_src]

        if smeta_f is not None:
            # Window-segment streamed chunk path (Reddit scale).

            def spmm_f(x):
                return spmm_tc_streamed(x, smeta_f)

            def spmm_b(dy):
                return spmm_tc_streamed(dy, smeta_t)

            def spmm_w_f(x, w):
                return spmm_tc_streamed(x, smeta_f, edge_weights=w)

            def spmm_w_b(dy, w):
                return spmm_tc_streamed(dy, smeta_t, edge_weights=to_t(w))

            def sddmm_f(xa, xb):
                return sddmm_tc_streamed(xa, smeta_f, xb)

        elif self.dense_tiles and bd_pack_f is not None:
            cfg = self.config

            def _bd_spmm(x, pack, offsets):
                tiles, res_meta, res_a = pack[:3]
                out = spmm_block_diag(x, tiles, offsets=offsets, cfg=cfg)
                if res_meta is not None:
                    out = out + spmm_tc_dense(x, res_meta, res_a)
                return out

            def spmm_f(x):
                return _bd_spmm(x, bd_pack_f, self._bd_offsets)

            def spmm_b(dy):
                return _bd_spmm(dy, bd_pack_t, self._bd_offsets_t)

            # Weighted SpMM / SDDMM stay in BD tile space: per-edge weights
            # scatter into a transient [Bp, bn, K*bn] pack (compute dtype)
            # and scores come off one batched x_bins @ stack^T matmul — no
            # condensed-space weighted-tile materialization (OVCAR-class:
            # 2.4 GB per layer) and no condensed gather.  Packs whose flat
            # space exceeds int32 (cov_pack is None — x64 is off, indices
            # would truncate) keep the condensed weighted/SDDMM ops below.
            n_edges = self.num_edges
            bd_per_edge_ok = (
                bd_pack_f[3] is not None and bd_pack_t[3] is not None
            )

            def _bd_weighted(x, w_dir, pack, offsets):
                tiles, res_meta, _, cov_pack, cov_ids, res_ids = pack[:6]
                bp, bn = tiles.shape[0], tiles.shape[1]
                wt = bd_scatter_weights(
                    w_dir[cov_ids], cov_pack,
                    bp=bp, bn=bn, k=len(offsets), dtype=cfg.compute_dtype,
                )
                out = spmm_block_diag(x, wt, offsets=offsets, cfg=cfg)
                if res_meta is not None:
                    out = out + spmm_tc_dense(
                        x, res_meta, build_a_tiles(res_meta, w_dir[res_ids]),
                        )
                return out

            if bd_per_edge_ok:

                def spmm_w_f(x, w):
                    return _bd_weighted(x, w, bd_pack_f, self._bd_offsets)

                def spmm_w_b(dy, w):
                    return _bd_weighted(
                        dy, to_t(w), bd_pack_t, self._bd_offsets_t
                    )

                def sddmm_f(xa, xb):
                    (tiles, _, _, _, _, res_ids,
                     pos_pad, e_start, res_rc) = bd_pack_f
                    bn = tiles.shape[1]
                    cb, nc, cap = self._bd_sddmm_chunks
                    # Edge-dot-only chunked path (ops/spmm.bd_sddmm_edges):
                    # computes the E dots and nothing else — no score-pack
                    # materialization, no E-element scatter OR flat gather.
                    e = bd_sddmm_edges(
                        xa, xb, pos_pad, e_start,
                        num_edges=n_edges, cap=cap, chunk_bins=cb,
                        n_chunks=nc, bn=bn, offsets=self._bd_offsets,
                        cfg=cfg,
                    )
                    if res_rc is not None:
                        # Residual scores: per-edge dots via two R-row
                        # global gathers, landed by an R-element scatter
                        # (R ~ a few % of E), instead of an E-wide
                        # where/gather merge.
                        ct = cfg.compute_dtype
                        rr, rc_ = res_rc
                        r = jnp.sum(
                            xa.astype(ct)[rr].astype(jnp.float32)
                            * xb.astype(ct)[rc_].astype(jnp.float32),
                            axis=1,
                        )
                        e = e.at[res_ids].set(r)
                    return e

            else:

                def spmm_w_f(x, w):
                    return spmm_tc_dense(x, meta, build_a_tiles(meta, w))

                def spmm_w_b(dy, w):
                    return spmm_tc_dense(
                        dy, meta_t, build_a_tiles(meta_t, to_t(w)),
                        )

                if sddmm_ext is not None:
                    sddmm_f = _edge_dot_sddmm
                else:

                    def sddmm_f(xa, xb):
                        return sddmm_tc_dense(xa, meta, xb)

        elif self.dense_tiles:

            def spmm_f(x):
                return spmm_tc_dense(x, meta, a_struct)

            def spmm_b(dy):
                return spmm_tc_dense(dy, meta_t, a_struct_t)

            def spmm_w_f(x, w):
                return spmm_tc_dense(x, meta, build_a_tiles(meta, w))

            def spmm_w_b(dy, w):
                return spmm_tc_dense(dy, meta_t, build_a_tiles(meta_t, to_t(w)))

            if sddmm_ext is not None:
                sddmm_f = _edge_dot_sddmm
            else:

                def sddmm_f(xa, xb):
                    return sddmm_tc_dense(xa, meta, xb)

        else:

            def spmm_f(x):
                return spmm_tc(x, meta)

            def spmm_b(dy):
                return spmm_tc(dy, meta_t)

            def spmm_w_f(x, w):
                return spmm_tc(x, meta, edge_weights=w)

            def spmm_w_b(dy, w):
                return spmm_tc(dy, meta_t, edge_weights=to_t(w))

            def sddmm_f(xa, xb):
                return sddmm_tc(xa, meta, xb)

        # Mixed-precision boundary: the dense-tile and block-diagonal ops
        # return the compute dtype (half-width writes under bf16; f32
        # configs are unchanged), and the models run their dense math in
        # the compute dtype too (models/layers._amp_dot) with only the loss
        # pinned f32.  custom_vjp cotangents are cast to each primal's
        # dtype so callers may feed f32 or bf16 operands freely.

        # ---- unweighted SpMM (TCGNN.forward / backward) -------------------
        @jax.custom_vjp
        def spmm(x):
            return spmm_f(x)

        def spmm_fwd(x):
            # zero-size residual carries the primal dtype for the bwd cast
            return spmm(x), jnp.zeros((0,), x.dtype)

        def spmm_bwd(res, dy):
            return (spmm_b(dy).astype(res.dtype),)

        spmm.defvjp(spmm_fwd, spmm_bwd)

        # ---- weighted SpMM (TCGNN.forward_AGNN) ---------------------------
        @jax.custom_vjp
        def spmm_weighted(x, w):
            return spmm_w_f(x, w)

        def spmm_weighted_fwd(x, w):
            return spmm_weighted(x, w), (x, w)

        def spmm_weighted_bwd(res, dy):
            x, w = res
            # dx[j] = sum_{e=(i->j)} w_e dy[i]  ==  (A w)^T @ dy
            dx = spmm_w_b(dy, w).astype(x.dtype)
            # dw_e = <dy[row_e], x[col_e]>  ==  SDDMM(dy, x)
            dw = sddmm_f(dy, x).astype(w.dtype)
            return dx, dw

        spmm_weighted.defvjp(spmm_weighted_fwd, spmm_weighted_bwd)

        # ---- SDDMM (TCGNN.forward_ef / backward_ef) ------------------------
        @jax.custom_vjp
        def sddmm(x):
            return sddmm_f(x, x)

        def sddmm_fwd(x):
            return sddmm(x), x

        def sddmm_bwd(x, de):
            # e_k = <x[row_k], x[col_k]>:
            #   dx via rows:  dx[i] += sum_{e row=i} de_e * x[col_e]
            #   dx via cols:  dx[j] += sum_{e col=j} de_e * x[row_e]
            d_rows = spmm_w_f(x, de)
            d_cols = spmm_w_b(x, de)
            return ((d_rows + d_cols).astype(x.dtype),)

        sddmm.defvjp(sddmm_fwd, sddmm_bwd)

        # ---- fused AGNN aggregation (score-fused ops) ----------------------
        # AGNN's edge attention is  att_e = c_h * e_e  with e = SDDMM(x), so
        # the head-averaged aggregation is  mean(c) * (A ⊙ S) x  with
        # S = X Xᵀ.  On symmetric graphs every forward/backward term of that
        # op rides the score-fused ops (`ops.spmm.spmm_sfused` /
        # `bd_sfused`), which work in tile space with no per-edge scatter,
        # and the backward's column-space term collapses to a regular pass
        # via (A ⊙ T)ᵀ = A ⊙ Tᵀ (A symmetric).  The whole backward — all
        # three dx terms AND the forward product u (for d attention) — is
        # ONE call of `spmm_sfused_bwd` / `bd_sfused_bwd`, mirroring the
        # reference's AGNN/GCN kernel parity (TCGNN_kernel.cu:459-578 vs
        # 336-454); no residual beyond x itself is saved.
        agnn_aggregate = None

        def _make_sfused_agnn(core, core_bwd):
            @jax.custom_vjp
            def agnn_aggregate(x, att_w):
                out = core(x, x, x)
                # Gate applied in the aggregate's own dtype: a f32 scalar
                # would promote (and materialize) the whole array to f32.
                return out * jnp.mean(att_w).astype(out.dtype)

            def agnn_fwd(x, att_w):
                return agnn_aggregate(x, att_w), (x, att_w)

            def agnn_bwd(res, dy):
                x, att_w = res
                cbar = jnp.mean(att_w)
                # dx = cbar * [(A⊙S) dy + (A⊙T) x + (A⊙Tᵀ) x] with
                # S_ij = <x_i, x_j>, T_ij = <dy_i, x_j>; Tᵀ is the same
                # score with the operands swapped.  One fused backward call
                # returns the sum plus u = (A⊙S) x for d attention.
                dx3, u = core_bwd(x, dy)
                dx = (cbar.astype(dx3.dtype) * dx3).astype(x.dtype)
                d_cbar = jnp.vdot(
                    dy.astype(jnp.float32), u.astype(jnp.float32)
                )
                datt = jnp.full(att_w.shape, d_cbar / att_w.size, att_w.dtype)
                return dx, datt

            agnn_aggregate.defvjp(agnn_fwd, agnn_bwd)
            return agnn_aggregate

        if self.dense_tiles and self.symmetric:
            cfg = self.config
            offs = self._bd_offsets
            # A partial-coverage residual is symmetric exactly when the
            # offset set is sign-symmetric (A itself is symmetric).
            bd_ok = bd_pack_f is not None and (
                self._bd_full_coverage or set(offs) == {-o for o in offs}
            )
            if bd_ok:
                bd_tiles, res_meta, res_a = bd_pack_f[:3]

                def core(l, r, v):
                    # bd_sfused / spmm_sfused share the gathered operand
                    # when v is r (object identity): agnn_aggregate passes
                    # x thrice, so keep these paths identity-preserving.
                    out = bd_sfused(l, r, v, bd_tiles, offsets=offs, cfg=cfg)
                    if res_meta is not None:
                        out = out + spmm_sfused(l, r, v, res_meta, res_a)
                    return out

                def core_bwd(x, dy):
                    dx3, u = bd_sfused_bwd(
                        x, dy, bd_tiles, offsets=offs, cfg=cfg
                    )
                    if res_meta is not None:
                        dx3_r, u_r = spmm_sfused_bwd(x, dy, res_meta, res_a)
                        dx3, u = dx3 + dx3_r, u + u_r
                    return dx3, u

                agnn_aggregate = _make_sfused_agnn(core, core_bwd)
            elif meta is not None:
                agnn_aggregate = _make_sfused_agnn(
                    lambda l, r, v: spmm_sfused(l, r, v, meta, a_struct),
                    lambda x, dy: spmm_sfused_bwd(x, dy, meta, a_struct),
                )

        # Transpose aggregation (A^T dy) exposed as a standalone op so the
        # measured per-stage epoch ledger (bench.epoch_ledger) can time the
        # backward pass's aggregation in isolation.
        return spmm, spmm_weighted, sddmm, agnn_aggregate, spmm_b


class BoundGraph:
    """A TiledGraph's op surface rebuilt over traced (jit-argument) arrays.

    Duck-types the pieces the model layers use: ``spmm``, ``spmm_weighted``,
    ``sddmm`` plus the shape attributes.
    """

    def __init__(self, parent: TiledGraph, ops):
        (self.spmm, self.spmm_weighted, self.sddmm, self.agnn_aggregate,
         self.spmm_t) = ops
        self.num_nodes = parent.num_nodes
        self.num_edges = parent.num_edges
        self.config = parent.config
        self.dense_tiles = parent.dense_tiles
        self.block_diag = parent.block_diag
        self.streamed = parent.streamed


def tiled_graph_from_dataset(ds, config: TileConfig = DEFAULT_CONFIG, **kw) -> TiledGraph:
    return TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, config, **kw)
