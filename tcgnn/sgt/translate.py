"""Sparse Graph Translation (SGT): condense CSR adjacency into dense tiles.

Re-design of the reference's preprocessing pass
(``/root/reference/TCGNN_conv/TCGNN.cpp:157-226`` — per 16-row window:
sort + dedup neighbor ids, remap to a condensed column space, count 16x8
TC blocks).  The math is identical, only the geometry and the output
layout change:

* windows are ``blk_h`` (default 512) rows, TC blocks ``blk_w`` (default
  128) condensed columns — wider than the reference's 16x8 WMMA tiles;
* instead of the GPU's ``edgeToColumn``/``edgeToRow`` arrays consumed by a
  per-thread-block shared-memory build (``TCGNN_kernel.cu:399-408``), we
  emit *uniform edge chunks*: every TC block's edge list is padded to a
  multiple of ``edge_chunk`` and laid out as dense ``[n_chunks, edge_chunk]``
  arrays.  This gives the chunk route a perfectly regular layout
  regardless of the graph's degree skew, with per-chunk metadata (owning
  block / window, first-chunk flags).

Everything here is vectorized NumPy — no Python loop over windows or
edges — so preprocessing large graphs stays fast even before the native
C++ path (``tcgnn/sgt/native``) is used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tcgnn.config import DEFAULT_CONFIG, TileConfig


def _cdiv(a, b):
    return -(-a // b)


def _pad_blocks(real_blocks_per_window: np.ndarray, config: TileConfig) -> np.ndarray:
    """Blocks per window, padded for the kernels.

    Empty windows get a padding block so every window owns at least one
    block, and counts round up to ``config.block_group`` so a group of
    consecutive blocks never straddles a window boundary.  Padding blocks have all-zero tiles and padding columns 0, so
    they contribute nothing.
    """
    g = max(int(config.block_group), 1)
    return (_cdiv(np.maximum(real_blocks_per_window, 1), g) * g).astype(
        real_blocks_per_window.dtype
    )


@dataclasses.dataclass
class SGTMeta:
    """Tiling metadata produced by :func:`sparse_graph_translate`.

    All arrays are host NumPy; ``as_jax()`` moves them to device.  Shapes use
    W = num_windows, B = num_blocks, Cn = num_chunks, EC = edge_chunk.
    """

    config: TileConfig
    num_nodes: int
    num_edges: int

    # --- per-window -------------------------------------------------------
    # Number of TC blocks per row window; reference's `blockPartition`
    # (TCGNN.cpp:216).  Empty windows get 1 padding block so every output
    # tile is written by the kernel.
    block_partition: np.ndarray  # [W] int32
    # Count of *real* blocks (empty windows contribute 0) — the reference's
    # printed `TC_Blocks` statistic (TCGNN.cpp:225).
    num_real_blocks: int

    # --- per-block --------------------------------------------------------
    # Global source-node id for each condensed column; padding columns -> 0
    # (their one-hot contributions are zero because no edge maps to them).
    # Counterpart of the GPU's per-block `sparse_AToX_index` gather table
    # (TCGNN_kernel.cu:406).
    col_ids: np.ndarray  # [B * blk_w] int32
    # Owning row window of each block, and whether the block is its window's
    # first — drive the dense-tile kernels' output index map / accumulator
    # init (the analogue of the WMMA accumulator's fill/store epilogue,
    # TCGNN_kernel.cu:372,453).
    block_window: np.ndarray  # [B] int32
    block_first_in_window: np.ndarray  # [B] int32 (0/1)

    # --- per-edge ---------------------------------------------------------
    # Flat dense-tile position of each CSR edge:
    # block * blk_h * blk_w + r * blk_w + c.  Scatters edge weights into
    # dense A-tiles and gathers SDDMM scores straight out of score tiles.
    edge_pos: np.ndarray  # [num_edges] int64 (host; int32 on device)

    # --- fused structural tiles (build_tiles=True) -------------------------
    # int8 (kernel storage format); f32 when duplicate counts overflow int8.
    a_tiles: Optional[np.ndarray] = None  # [B, blk_h, blk_w]

    # --- per-chunk (emit_chunks=True; fallback kernel layout) --------------
    chunk_r: Optional[np.ndarray] = None  # [Cn, EC] int32; blk_h = pad sentinel
    chunk_c: Optional[np.ndarray] = None  # [Cn, EC] int32, col-in-block
    chunk_edge_id: Optional[np.ndarray] = None  # [Cn, EC] int32; num_edges = pad
    chunk_block: Optional[np.ndarray] = None  # [Cn] int32, owning global block
    chunk_window: Optional[np.ndarray] = None  # [Cn] int32, owning row window
    chunk_first_in_window: Optional[np.ndarray] = None  # [Cn] int32 (0/1)
    chunk_first_in_block: Optional[np.ndarray] = None  # [Cn] int32 (0/1)
    # Flat chunk-layout slot of each CSR edge (chunk * EC + lane): gathers
    # chunk-ordered per-edge results (e.g. SDDMM scores) back to CSR order.
    edge_perm: Optional[np.ndarray] = None  # [num_edges] int32

    @property
    def num_windows(self) -> int:
        return int(self.block_partition.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.col_ids.shape[0] // self.config.blk_w)

    @property
    def num_chunks(self) -> int:
        return 0 if self.chunk_block is None else int(self.chunk_block.shape[0])

    @property
    def exp_edges(self) -> int:
        """Reference's `Exp_Edges` = TC_Blocks * blk_h * blk_w."""
        return self.num_real_blocks * self.config.blk_h * self.config.blk_w

    def max_duplicate_count(self) -> int:
        """Largest number of parallel edges landing on one tile slot.

        Decides int8-exactness of the structural tiles HOST-side (the
        device scatter then needs no value sync in prep).  One sort of
        ``edge_pos`` — simple graphs (every AE graph) return 1 via the
        all-unique fast path.
        """
        if self.num_edges <= 1:
            return 1
        sp = np.sort(self.edge_pos)
        dup = sp[1:] == sp[:-1]
        if not dup.any():
            return 1
        # Longest run of equal values = max duplicate count.
        changes = np.flatnonzero(np.diff(sp) != 0)
        run_bounds = np.concatenate(([-1], changes, [len(sp) - 1]))
        return int(np.diff(run_bounds).max())

    def as_jax(self, lite: bool = False):
        """Device-resident view of the metadata (jnp arrays).

        ``lite=True`` skips the chunk-layout arrays (dense-tile path only) —
        fewer host->device transfers, which matters on high-latency links.
        """
        import jax.numpy as jnp

        dense_size = self.num_blocks * self.config.blk_h * self.config.blk_w
        edge_pos32 = (
            jnp.asarray(self.edge_pos.astype(np.int32))
            if dense_size < 2**31
            else None  # dense-tile path unavailable; chunk path still works
        )
        skip = lite or self.chunk_block is None

        def dev(a):
            return None if (skip or a is None) else jnp.asarray(a)

        return JaxSGTMeta(
            config=self.config,
            num_nodes=self.num_nodes,
            num_edges=self.num_edges,
            num_windows=self.num_windows,
            num_blocks=self.num_blocks,
            num_chunks=self.num_chunks,
            col_ids=jnp.asarray(self.col_ids),
            block_window=jnp.asarray(self.block_window),
            block_first_in_window=jnp.asarray(self.block_first_in_window),
            edge_pos=edge_pos32,
            chunk_r=dev(self.chunk_r),
            chunk_c=dev(self.chunk_c),
            chunk_edge_id=dev(self.chunk_edge_id),
            chunk_block=dev(self.chunk_block),
            chunk_window=dev(self.chunk_window),
            chunk_first_in_window=dev(self.chunk_first_in_window),
            chunk_first_in_block=dev(self.chunk_first_in_block),
            edge_perm=dev(self.edge_perm),
        )


@dataclasses.dataclass(frozen=True)
class JaxSGTMeta:
    """Device-side SGT metadata pytree consumed by the SGT ops.

    Registered as a pytree so metadata can cross jit boundaries as explicit
    *arguments* — closing device arrays into a jitted step would embed them
    as HLO constants (multi-GB programs for big tile sets).
    """

    config: TileConfig
    num_nodes: int
    num_edges: int
    num_windows: int
    num_blocks: int
    num_chunks: int
    col_ids: "jax.Array"
    block_window: "jax.Array"
    block_first_in_window: "jax.Array"
    edge_pos: "jax.Array"  # int32, or None if the dense index space overflows
    chunk_r: "jax.Array"
    chunk_c: "jax.Array"
    chunk_edge_id: "jax.Array"
    chunk_block: "jax.Array"
    chunk_window: "jax.Array"
    chunk_first_in_window: "jax.Array"
    chunk_first_in_block: "jax.Array"
    edge_perm: "jax.Array"


_JAXMETA_ARRAY_FIELDS = (
    "col_ids",
    "block_window",
    "block_first_in_window",
    "edge_pos",
    "chunk_r",
    "chunk_c",
    "chunk_edge_id",
    "chunk_block",
    "chunk_window",
    "chunk_first_in_window",
    "chunk_first_in_block",
    "edge_perm",
)
_JAXMETA_STATIC_FIELDS = (
    "config",
    "num_nodes",
    "num_edges",
    "num_windows",
    "num_blocks",
    "num_chunks",
)


def _jaxmeta_flatten(m: JaxSGTMeta):
    children = tuple(getattr(m, f) for f in _JAXMETA_ARRAY_FIELDS)
    aux = tuple(getattr(m, f) for f in _JAXMETA_STATIC_FIELDS)
    return children, aux


def _jaxmeta_unflatten(aux, children):
    return JaxSGTMeta(**dict(zip(_JAXMETA_STATIC_FIELDS, aux)),
                      **dict(zip(_JAXMETA_ARRAY_FIELDS, children)))


import jax.tree_util as _jtu  # noqa: E402

_jtu.register_pytree_node(JaxSGTMeta, _jaxmeta_flatten, _jaxmeta_unflatten)


def sparse_graph_translate(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: Optional[int] = None,
    config: TileConfig = DEFAULT_CONFIG,
    num_cols: Optional[int] = None,
    impl: str = "auto",
    emit_chunks: bool = True,
    build_tiles: bool = False,
) -> SGTMeta:
    """Run the SGT tiling pass over a CSR adjacency.

    Semantics match the reference pass (``TCGNN.cpp:172-226``): per
    ``blk_h``-row window, the set of distinct neighbor column ids is ranked
    in sorted order; edge ``e`` with neighbor ``c`` in window ``w`` lands at
    condensed column ``rank_w(c)``, i.e. TC block ``rank // blk_w``, in-block
    column ``rank % blk_w``, in-window row ``row(e) % blk_h``.

    Args:
      row_pointers: CSR indptr, shape [N+1], int.
      column_index: CSR indices, shape [nnz], int.
      num_nodes: N (row count); defaults to len(row_pointers) - 1.
      config: tile geometry.
      num_cols: column-space size; defaults to num_nodes.  Distributed
        shards tile a *rectangular* local slice (local rows x global
        columns), so the column space can exceed the row count.
      impl: "native" (C++/OpenMP pass, the reference-N1 analogue), "numpy"
        (vectorized host pass), or "auto" (native when built).
      emit_chunks: also lay out the uniform edge chunks for the chunk-kernel
        fallback; the dense-tile path doesn't need them.
      build_tiles: fuse structural dense A-tile materialization into the
        pass (stored in ``meta.a_tiles``).

    Returns:
      An :class:`SGTMeta` (chunk fields None when ``emit_chunks=False``).
    """
    blk_h, blk_w, ec = config.blk_h, config.blk_w, config.edge_chunk
    row_pointers = np.asarray(row_pointers, dtype=np.int64)
    column_index = np.asarray(column_index, dtype=np.int64)
    if num_nodes is None:
        num_nodes = len(row_pointers) - 1
    num_edges = int(column_index.shape[0])
    num_windows = max(_cdiv(num_nodes, blk_h), 1)
    if num_cols is None:
        num_cols = num_nodes
    num_cols = max(
        int(num_cols), int(column_index.max()) + 1 if num_edges else 1
    )

    from tcgnn.sgt import native

    use_native = impl == "native" or (impl == "auto" and native.available())
    tile = blk_h * blk_w
    a_tiles = None

    if use_native:
        # C++/OpenMP pass (the reference-N1 analogue, TCGNN.cpp:172-226):
        # per-window sort+dedup+rank, optionally fused with tile build.
        col32 = np.ascontiguousarray(column_index, dtype=np.int32)
        rp64 = np.ascontiguousarray(row_pointers, dtype=np.int64)
        real_blocks_per_window = native.count_blocks(rp64, col32, blk_h, blk_w)
        if len(real_blocks_per_window) < num_windows:  # empty trailing rows
            real_blocks_per_window = np.pad(
                real_blocks_per_window, (0, num_windows - len(real_blocks_per_window))
            )
        blocks_per_window = _pad_blocks(real_blocks_per_window, config)
        block_start = np.zeros(num_windows + 1, dtype=np.int64)
        np.cumsum(blocks_per_window, out=block_start[1:])
        num_blocks = int(block_start[-1])
        num_real_blocks = int(real_blocks_per_window.sum())
        col_ids, edge_pos, a_flat, overflow = native.fill(
            rp64, col32, block_start, blk_h, blk_w, build_tiles
        )
        if build_tiles:
            if overflow:
                # rare multigraph case: >127 duplicate edges in one slot
                a_flat = np.bincount(
                    edge_pos, minlength=num_blocks * tile
                ).astype(np.float32)
            a_tiles = a_flat.reshape(num_blocks, blk_h, blk_w)
        # (chunk layout below goes through the native pass directly from
        # edge_pos; no per-edge r/c materialization needed here)
    else:
        degrees = np.diff(row_pointers)
        edge_row = np.repeat(np.arange(num_nodes, dtype=np.int64), degrees)
        edge_window = edge_row // blk_h

        # ---- condensed-column ranking (the sort+dedup of TCGNN.cpp:209-223)
        # Unique (window, col) pairs in sorted order; inverse gives each
        # edge's pair id, and the pair's rank within its window is its
        # condensed column.
        key = edge_window * np.int64(num_cols) + column_index
        uniq_key, edge_pair = np.unique(key, return_inverse=True)
        pair_window = (uniq_key // num_cols).astype(np.int64)
        pair_col = (uniq_key % num_cols).astype(np.int64)
        uniques_per_window = np.bincount(pair_window, minlength=num_windows)
        window_pair_start = np.zeros(num_windows + 1, dtype=np.int64)
        np.cumsum(uniques_per_window, out=window_pair_start[1:])
        pair_rank = (
            np.arange(len(uniq_key), dtype=np.int64) - window_pair_start[pair_window]
        )

        # ---- block partition (TCGNN.cpp:216) ------------------------------
        real_blocks_per_window = _cdiv(uniques_per_window, blk_w)
        num_real_blocks = int(real_blocks_per_window.sum())
        blocks_per_window = _pad_blocks(real_blocks_per_window, config)
        block_start = np.zeros(num_windows + 1, dtype=np.int64)
        np.cumsum(blocks_per_window, out=block_start[1:])
        num_blocks = int(block_start[-1])

        # ---- per-block condensed-column gather table -----------------------
        pair_block = block_start[pair_window] + pair_rank // blk_w
        col_ids = np.zeros(num_blocks * blk_w, dtype=np.int32)
        col_ids[pair_block * blk_w + pair_rank % blk_w] = pair_col

        # ---- edge -> (block, row, col) -------------------------------------
        edge_rank = pair_rank[edge_pair]
        edge_block = pair_block[edge_pair]
        edge_c = (edge_rank % blk_w).astype(np.int32)
        edge_r = (edge_row % blk_h).astype(np.int32)
        edge_pos = (
            edge_block * np.int64(tile)
            + edge_r.astype(np.int64) * blk_w
            + edge_c.astype(np.int64)
        )
        if build_tiles:
            counts = np.bincount(edge_pos, minlength=num_blocks * tile)
            a_tiles = counts.astype(
                np.int8 if counts.max(initial=0) <= 127 else np.float32
            ).reshape(num_blocks, blk_h, blk_w)

    window_of_block = np.repeat(
        np.arange(num_windows, dtype=np.int32), blocks_per_window
    )
    block_first_in_window = np.zeros(num_blocks, dtype=np.int32)
    block_first_in_window[block_start[:-1]] = 1

    if not emit_chunks:
        return SGTMeta(
            config=config,
            num_nodes=int(num_nodes),
            num_edges=num_edges,
            block_partition=blocks_per_window.astype(np.int32),
            num_real_blocks=num_real_blocks,
            col_ids=col_ids,
            block_window=window_of_block,
            block_first_in_window=block_first_in_window,
            edge_pos=edge_pos,
            a_tiles=a_tiles,
        )

    # ---- uniform chunk layout ----------------------------------------------
    # Edges sorted by owning block (CSR order kept within a block); each
    # block's run is padded to a multiple of `ec`; blocks from the same
    # window stay adjacent so output-tile revisiting is consecutive.  The
    # native pass builds the layout in one O(E) scan over edge_pos; the
    # numpy fallback sorts.
    if use_native:
        (
            chunk_r, chunk_c, chunk_edge_id, edge_perm,
            chunks_per_block, block_chunk_start,
        ) = native.chunk_layout(
            edge_pos, num_blocks, blk_h, blk_w, ec, config.row_sentinel
        )
        num_chunks = int(block_chunk_start[-1])
    else:
        edge_block = edge_pos // tile
        rem = edge_pos % tile
        edge_r = (rem // blk_w).astype(np.int32)
        edge_c = (rem % blk_w).astype(np.int32)
        order = np.argsort(edge_block, kind="stable")
        edges_per_block = np.bincount(edge_block, minlength=num_blocks)
        chunks_per_block = np.maximum(_cdiv(edges_per_block, ec), 1)
        block_chunk_start = np.zeros(num_blocks + 1, dtype=np.int64)
        np.cumsum(chunks_per_block, out=block_chunk_start[1:])
        num_chunks = int(block_chunk_start[-1])

        # Slot of each (sorted) edge within its block.
        block_edge_start = np.zeros(num_blocks + 1, dtype=np.int64)
        np.cumsum(edges_per_block, out=block_edge_start[1:])
        sorted_block = edge_block[order]
        slot_in_block = np.arange(num_edges, dtype=np.int64) - block_edge_start[sorted_block]
        edge_chunk_idx = block_chunk_start[sorted_block] + slot_in_block // ec
        edge_lane = slot_in_block % ec
        flat_slot = edge_chunk_idx * ec + edge_lane

        chunk_r = np.full((num_chunks, ec), config.row_sentinel, dtype=np.int32)
        chunk_c = np.zeros((num_chunks, ec), dtype=np.int32)
        chunk_edge_id = np.full((num_chunks, ec), num_edges, dtype=np.int32)
        chunk_r.reshape(-1)[flat_slot] = edge_r[order]
        chunk_c.reshape(-1)[flat_slot] = edge_c[order]
        chunk_edge_id.reshape(-1)[flat_slot] = order.astype(np.int32)

        edge_perm = np.empty(num_edges, dtype=np.int32)
        edge_perm[order] = flat_slot.astype(np.int32)

    # ---- per-chunk scalar metadata -----------------------------------------
    chunk_block = np.repeat(
        np.arange(num_blocks, dtype=np.int32), chunks_per_block
    )
    chunk_window = window_of_block[chunk_block]
    chunk_first_in_block = np.zeros(num_chunks, dtype=np.int32)
    chunk_first_in_block[block_chunk_start[:-1]] = 1
    chunk_first_in_window = np.zeros(num_chunks, dtype=np.int32)
    chunk_first_in_window[block_chunk_start[block_start[:-1]]] = 1

    return SGTMeta(
        config=config,
        num_nodes=int(num_nodes),
        num_edges=num_edges,
        block_partition=blocks_per_window.astype(np.int32),
        num_real_blocks=num_real_blocks,
        col_ids=col_ids,
        block_window=window_of_block,
        block_first_in_window=block_first_in_window,
        edge_pos=edge_pos,
        a_tiles=a_tiles,
        chunk_r=chunk_r,
        chunk_c=chunk_c,
        chunk_edge_id=chunk_edge_id,
        chunk_block=chunk_block,
        chunk_window=chunk_window,
        chunk_first_in_window=chunk_first_in_window,
        chunk_first_in_block=chunk_first_in_block,
        edge_perm=edge_perm,
    )


def build_a_tiles_host(meta: SGTMeta, weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Host-side dense A-tile materialization (f32 NumPy, bincount scatter).

    Device-side building (``tcgnn.ops.spmm.build_a_tiles``) is for
    weighted tiles inside a jitted step; structural tiles are built once at
    preprocessing, where a bincount is much cheaper than compiling an XLA
    scatter.
    """
    if weights is None and meta.a_tiles is not None:
        return meta.a_tiles  # fused into the native pass
    cfg = meta.config
    size = meta.num_blocks * cfg.blk_h * cfg.blk_w
    if weights is None:
        # One-pass direct build, then an exact integer sum check: simple
        # graphs (all AE graphs) have one edge per tile slot, so assignment
        # == bincount and skips bincount's int64 intermediate (3 full-size
        # passes on multi-hundred-MB tile arrays).  A collapsed duplicate
        # makes the count come up short -> redo with the exact bincount.
        flat = np.zeros(size, np.float32)
        flat[meta.edge_pos] = 1.0
        if int(flat.sum(dtype=np.int64)) == meta.num_edges:
            return flat.reshape(meta.num_blocks, cfg.blk_h, cfg.blk_w)
    flat = np.bincount(
        meta.edge_pos,
        weights=None if weights is None else weights.astype(np.float64),
        minlength=size,
    ).astype(np.float32)
    return flat.reshape(meta.num_blocks, cfg.blk_h, cfg.blk_w)


def count_blocks(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    config: TileConfig = DEFAULT_CONFIG,
    per_window: np.ndarray | None = None,
) -> int:
    """Total block count (incl. empty-window padding blocks) without running
    the full translation — used to pick dense vs chunk kernels up front.

    ``per_window``: precomputed per-window real block counts (the native
    counting pass) — callers that already ran it (block_group auto
    resolution) pass it through instead of re-counting the graph."""
    from tcgnn.sgt import native

    if per_window is not None or native.available():
        if per_window is None:
            rp64 = np.ascontiguousarray(row_pointers, dtype=np.int64)
            col32 = np.ascontiguousarray(column_index, dtype=np.int32)
            per_window = native.count_blocks(
                rp64, col32, config.blk_h, config.blk_w
            )
        real = np.asarray(per_window)
        num_windows = max(_cdiv(num_nodes, config.blk_h), 1)
        if len(real) < num_windows:
            real = np.pad(real, (0, num_windows - len(real)))
        return int(_pad_blocks(real, config).sum())
    meta = sparse_graph_translate(
        row_pointers, column_index, num_nodes, config, emit_chunks=False
    )
    return meta.num_blocks


def transpose_csr(row_pointers: np.ndarray, column_index: np.ndarray, num_nodes: int):
    """CSR of the transposed adjacency (for correct backward on directed graphs).

    The reference aliases backward to the forward SpMM, silently assuming a
    symmetric adjacency (``TCGNN.cpp:270``); we keep explicit transpose
    metadata so gradients are correct for any graph.

    Returns:
      (t_row_pointers, t_column_index, t_edge_src): transpose CSR plus, per
      transpose edge k, the id of the corresponding forward edge — used to
      carry per-edge weights into the backward SpMM.
    """
    from tcgnn.sgt import native

    if native.available():
        # O(nnz) counting sort in C++ (reddit: ~2 s vs ~27 s numpy argsort).
        t_ptr, t_cols, t_src = native.transpose(
            row_pointers, column_index, num_nodes
        )
        return t_ptr.astype(np.int32), t_cols, t_src
    degrees = np.diff(np.asarray(row_pointers, dtype=np.int64))
    src = np.repeat(np.arange(num_nodes, dtype=np.int64), degrees)
    dst = np.asarray(column_index, dtype=np.int64)
    # Stable sort by dst: within a transpose row the src columns come out
    # ascending (forward CSR iterates src ascending), i.e. CSR-sorted.
    order = np.argsort(dst, kind="stable")
    t_cols = src[order].astype(np.int32)
    t_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=t_ptr[1:])
    return t_ptr.astype(np.int32), t_cols, order.astype(np.int32)
