"""Window-segment streaming for the edge-chunk route.

The one-shot chunk form keeps per-chunk arrays for the whole graph and
gathers the SGT-condensed neighbour slab ``[num_blocks*blk_w, D]`` in one
piece.  At Reddit scale (230k nodes / 100M+ edges) both are large: 172k+
chunks, and a condensed slab that alone rivals device memory.

This module re-lays the chunk metadata as S *window-aligned segments* of
uniform geometry (``wseg`` windows each, chunk/block counts padded to the
per-segment maxima).  The streamed ops (``ops.spmm.spmm_tc_streamed``,
``ops.sddmm.sddmm_tc_streamed``) then ``lax.scan`` one compiled segment op
over the stacked segments: per-step chunk metadata is ``C_max`` chunks and
per-step slab is ``B_max*blk_w`` rows, both bounded by construction, while
the full feature matrix (only O(N*D)) stays resident.  This is the
single-device analogue of the distributed layer's window-aligned
partitioning (``parallel/partition``) — same cut points, executed
sequentially on one device instead of spatially over a mesh.

The reference has no counterpart: its largest recorded artifact for Reddit
is the SGT block count (``/root/reference/logs/reduce_blocks.csv:17``); the
CUDA kernels there would need the same treatment to run it.

Segment padding reuses the chunk form's sentinels (``chunk_r = blk_h``
rows match nothing; ``chunk_edge_id = num_edges`` reads the appended zero
weight; padded chunks point at the segment's LAST window, so window maps
stay non-decreasing and contribute zero).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tcgnn.config import TileConfig
from tcgnn.sgt.translate import SGTMeta

# Per-segment ceilings: chunks of metadata and condensed-slab rows one scan
# step holds.  The values were sized for an earlier accelerator's on-chip
# memory and are not measured on the H100 (ROADMAP A4).
MAX_PREFETCH_CHUNKS = 49_152
MAX_SLAB_ROWS = 1 << 20               # 1.05M rows; 0.5 GB at D=128 f32


def needs_streaming(meta: SGTMeta) -> bool:
    """True when the one-shot chunk form would exceed the per-step ceilings."""
    num_blocks = meta.col_ids.shape[0] // meta.config.blk_w
    return (
        meta.num_chunks > MAX_PREFETCH_CHUNKS
        or num_blocks * meta.config.blk_w > MAX_SLAB_ROWS
    )


@dataclasses.dataclass(frozen=True)
class StreamedJaxMeta:
    """Device-side stacked-segment metadata (pytree, jit-traversable)."""

    config: TileConfig
    num_nodes: int
    num_edges: int
    num_windows: int          # real windows (pre-padding)
    wseg: int                 # windows per segment (uniform)
    num_segments: int
    seg_col_ids: "jax.Array"       # [S, B_max*blk_w] int32
    seg_r: "jax.Array"             # [S, C_max, EC] int32
    seg_c: "jax.Array"             # [S, C_max, EC] int32
    seg_edge_id: "jax.Array"       # [S, C_max, EC] int32
    seg_block: "jax.Array"         # [S, C_max] int32 (segment-relative)
    seg_window: "jax.Array"        # [S, C_max] int32 (segment-relative)
    seg_first: "jax.Array"         # [S, C_max] int32
    edge_perm: "jax.Array"         # [E] into the stacked score layout


_S_ARRAY_FIELDS = (
    "seg_col_ids", "seg_r", "seg_c", "seg_edge_id",
    "seg_block", "seg_window", "seg_first", "edge_perm",
)
_S_STATIC_FIELDS = (
    "config", "num_nodes", "num_edges", "num_windows", "wseg", "num_segments",
)


def _smeta_flatten(m: StreamedJaxMeta):
    return (
        tuple(getattr(m, f) for f in _S_ARRAY_FIELDS),
        tuple(getattr(m, f) for f in _S_STATIC_FIELDS),
    )


def _smeta_unflatten(aux, children):
    return StreamedJaxMeta(
        **dict(zip(_S_STATIC_FIELDS, aux)),
        **dict(zip(_S_ARRAY_FIELDS, children)),
    )


import jax.tree_util as _jtu  # noqa: E402

_jtu.register_pytree_node(StreamedJaxMeta, _smeta_flatten, _smeta_unflatten)


def segment_chunks(
    meta: SGTMeta,
    *,
    max_chunks: int = MAX_PREFETCH_CHUNKS,
    max_slab_rows: int = MAX_SLAB_ROWS,
    num_segments: Optional[int] = None,
    pad_chunks_to: Optional[int] = None,
    pad_slab_blocks_to: Optional[int] = None,
    plan_only: bool = False,
    to_device: bool = True,
) -> StreamedJaxMeta:
    """Re-lay chunk metadata as uniform window segments (host pass).

    Chooses the smallest S (unless ``num_segments`` forces one) such that
    every segment's chunk count fits ``max_chunks`` and its
    condensed-slab rows fit ``max_slab_rows``; cuts are at window
    boundaries, so per-window chunk runs (and their first-in-window flags)
    transfer unchanged.

    ``pad_chunks_to`` / ``pad_slab_blocks_to`` force the per-segment
    chunk / block capacities past the natural maxima — the distributed
    streamed path stacks several shards' segment arrays and needs
    uniform shapes across shards.  ``plan_only=True`` returns just
    ``(S, wseg, c_max, b_max)`` without building the (GB-scale) arrays,
    so the cross-shard maxima can be agreed on first.
    ``to_device=False`` keeps the arrays as host numpy (the distributed
    builder stacks per-shard metas and uploads ONCE sharded — a device
    round trip here would move GBs twice).
    """
    import jax.numpy as jnp

    cfg = meta.config
    blk_h, blk_w = cfg.blk_h, cfg.blk_w
    W = len(meta.block_partition)
    ec = meta.chunk_r.shape[1]
    block_start = np.zeros(W + 1, dtype=np.int64)
    np.cumsum(meta.block_partition, out=block_start[1:])
    chunk_block = np.asarray(meta.chunk_block, np.int64)

    def cuts_for(S):
        wseg = -(-W // S)
        S_eff = -(-W // wseg)
        w_cuts = np.minimum(np.arange(S_eff + 1) * wseg, W)
        b_cuts = block_start[w_cuts]
        c_cuts = np.searchsorted(chunk_block, b_cuts, side="left")
        return wseg, S_eff, w_cuts, b_cuts, c_cuts

    if num_segments is not None:
        wseg, S, w_cuts, b_cuts, c_cuts = cuts_for(num_segments)
    else:
        for S in range(1, W + 1):
            wseg, S, w_cuts, b_cuts, c_cuts = cuts_for(S)
            b_max = int(np.max(np.diff(b_cuts)))
            c_max = int(np.max(np.diff(c_cuts)))
            if b_max * blk_w <= max_slab_rows and c_max <= max_chunks:
                break
    b_max = int(np.max(np.diff(b_cuts)))
    c_max = max(int(np.max(np.diff(c_cuts))), 1)
    if pad_slab_blocks_to is not None:
        assert pad_slab_blocks_to >= b_max, (pad_slab_blocks_to, b_max)
        b_max = pad_slab_blocks_to
    if pad_chunks_to is not None:
        assert pad_chunks_to >= c_max, (pad_chunks_to, c_max)
        c_max = pad_chunks_to
    if plan_only:
        return S, wseg, c_max, b_max

    # np.empty + explicit pad-tail writes: the copy loop fills [:nc] anyway,
    # so np.full would touch the ~GB-scale arrays twice (reddit: 1.8 GB of
    # segment metadata — measured ~7 s of pure np.full).
    seg_r = np.empty((S, c_max, ec), np.int32)
    seg_c = np.empty((S, c_max, ec), np.int32)
    seg_eid = np.empty((S, c_max, ec), np.int32)
    seg_block = np.zeros((S, c_max), np.int32)
    seg_window = np.zeros((S, c_max), np.int32)
    seg_first = np.zeros((S, c_max), np.int32)
    seg_col_ids = np.zeros((S, b_max * blk_w), np.int32)

    for s in range(S):
        c0, c1 = int(c_cuts[s]), int(c_cuts[s + 1])
        b0, b1 = int(b_cuts[s]), int(b_cuts[s + 1])
        w0 = int(w_cuts[s])
        nc = c1 - c0
        if nc:
            seg_r[s, :nc] = meta.chunk_r[c0:c1]
            seg_c[s, :nc] = meta.chunk_c[c0:c1]
            seg_eid[s, :nc] = meta.chunk_edge_id[c0:c1]
            seg_block[s, :nc] = meta.chunk_block[c0:c1] - b0
            seg_window[s, :nc] = meta.chunk_window[c0:c1] - w0
            # Padding chunks revisit the last real window consecutively with
            # first=0: zero contribution, monotone output map.
            seg_window[s, nc:] = int(meta.chunk_window[c1 - 1]) - w0
            seg_first[s, :nc] = meta.chunk_first_in_window[c0:c1]
        seg_r[s, nc:] = blk_h                 # row sentinel
        seg_c[s, nc:] = 0
        seg_eid[s, nc:] = meta.num_edges
        seg_col_ids[s, : (b1 - b0) * blk_w] = meta.col_ids[b0 * blk_w : b1 * blk_w]

    _dev = jnp.asarray if to_device else np.asarray

    # SDDMM score layout moves from [Cn, EC] to [S, C_max, EC]; remap the
    # per-edge permutation accordingly.
    ep = np.asarray(meta.edge_perm, np.int64)
    gc, k = ep // ec, ep % ec
    seg_id = np.searchsorted(c_cuts, gc, side="right") - 1
    new_perm = (seg_id * np.int64(c_max) + (gc - c_cuts[seg_id])) * ec + k
    perm_dtype = np.int32 if S * c_max * ec < 2**31 else np.int64

    return StreamedJaxMeta(
        config=cfg,
        num_nodes=meta.num_nodes,
        num_edges=meta.num_edges,
        num_windows=W,
        wseg=wseg,
        num_segments=S,
        seg_col_ids=_dev(seg_col_ids),
        seg_r=_dev(seg_r),
        seg_c=_dev(seg_c),
        seg_edge_id=_dev(seg_eid),
        seg_block=_dev(seg_block),
        seg_window=_dev(seg_window),
        seg_first=_dev(seg_first),
        edge_perm=_dev(new_perm.astype(perm_dtype)),
    )
