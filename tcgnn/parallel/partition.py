"""Row-window-aligned graph partitioning for multi-chip training.

The reference has no distributed support of any kind (single GPU, one
process — see SURVEY.md §2.3); its only parallelism is intra-kernel:
row-window -> thread block (``/root/reference/TCGNN_kernel.cu:348``).  This
module generalizes exactly that decomposition across a device mesh: the
*row window* (``blk_h`` output rows) stays the atomic unit of work, and a
device shard owns a contiguous range of windows.

Because SGT's sort+dedup is strictly per-window (``TCGNN.cpp:199-224``),
window-aligned partitioning is *semantics-preserving*: each shard's local
tiling is bit-identical to the corresponding slice of a single-device
tiling.  Per-shard metadata is padded to common shapes and stacked with a
leading ``[num_shards, ...]`` axis so it can be laid out with
``NamedSharding(mesh, P('graph'))`` — every device holds exactly its own
slab and the ops see perfectly static local shapes.

Edge sharding falls out for free: a shard's rows are a contiguous CSR row
range, so its edges are the contiguous slice
``[row_pointers[r0], row_pointers[r1])`` — per-edge vectors (SDDMM scores,
attention weights) live as ``[num_shards * edge_capacity]`` arrays sharded
on the same axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tcgnn.config import DEFAULT_CONFIG, TileConfig
from tcgnn.sgt.translate import SGTMeta, sparse_graph_translate, transpose_csr


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass
class ShardedSGTMeta:
    """Stacked per-shard SGT metadata (host NumPy).

    Shapes: G = num_shards, Cn = chunk capacity (max over shards), EC =
    edge_chunk, Bw = block capacity * blk_w, Emax = edge capacity.

    ``chunk_edge_id`` holds *local* edge ids in ``[0, Emax)`` with sentinel
    ``Emax`` for padding slots; ``chunk_fwd_slot`` (transpose metadata only)
    holds *global padded-layout* forward-edge slots ``shard * Emax + local``
    with sentinel ``G * Emax`` — the index space of an all-gathered edge
    vector.
    """

    config: TileConfig
    num_shards: int
    num_nodes: int          # real nodes N
    num_edges: int          # real edges E
    rows_per_shard: int     # Wd * blk_h
    windows_per_shard: int  # Wd
    edge_capacity: int      # Emax
    num_real_blocks: int    # summed over shards == single-device TC_Blocks

    edge_start: np.ndarray        # [G+1] int64, global CSR edge offsets per shard
    col_ids: np.ndarray           # [G, Bw] int32
    # --- dense-tile path (per-shard, block-padded to the common Bmax) -----
    a_tiles: np.ndarray           # [G, Bmax, blk_h, blk_w] int8 structural tiles
    #                               (compute dtype if counts overflow int8)
    block_window: np.ndarray      # [G, Bmax] int32 (local window; pad -> last)
    block_first_in_window: np.ndarray  # [G, Bmax] int32 (pad -> 0)
    edge_pos: np.ndarray          # [G, Emax] int32 local dense slot (pad -> 0)
    # --- chunk fallback ----------------------------------------------------
    chunk_r: np.ndarray           # [G, Cn, EC] int32
    chunk_c: np.ndarray           # [G, Cn, EC] int32
    chunk_edge_id: np.ndarray     # [G, Cn, EC] int32 (local ids, sentinel Emax)
    chunk_block: np.ndarray       # [G, Cn] int32
    chunk_window: np.ndarray      # [G, Cn] int32 (local window)
    chunk_first_in_window: np.ndarray  # [G, Cn] int32
    edge_perm: np.ndarray         # [G, Emax] int32 -> chunk slot of local edge
    edge_valid: np.ndarray        # [G, Emax] bool (real edge slots)
    chunk_fwd_slot: Optional[np.ndarray] = None  # [G, Cn, EC] int32
    # Halo-overlap split (unweighted SpMM): {"local": {...}, "remote": {...}}
    # each with stacked a_tiles/col_ids/block_window/block_first_in_window.
    # Local-class col_ids are shard-relative (index the resident slab).
    overlap: Optional[dict] = None
    # Per local transpose edge: global padded-layout forward slot
    # shard * Emax_fwd + local_fwd (sentinel G * Emax_fwd) — lets the
    # backward build weighted tiles from forward-ordered weights after an
    # all-gather.
    edge_fwd_slot: Optional[np.ndarray] = None  # [G, Emax] int32
    # Boundary-only halo exchange (see build_halo): per-shard-pair request
    # lists + col_ids remapped into the [rows_per_shard + halo_rows]
    # extended slab each device assembles from one cyclic ppermute per
    # owner offset (each padded to that offset's max pair count).
    #   {"capacity": H (global max pair, stats only),
    #    "offset_caps": ((o, cap_o), ...) static exchange plan,
    #    "halo_rows": sum(cap_o),
    #    "send_idx":    [G, halo_rows] int32 (per-offset send segments),
    #    "col_ids_ext": [G, Bmax*blk_w] int32,
    #    "overlap_remote_col_ids_ext": [G, ...] int32 | None}
    halo: Optional[dict] = None
    # Mega-window block-stream split (see build_split): replaces the
    # unweighted dense SpMM's stream with one where overloaded windows'
    # block tails are computed by underloaded shards as "guest windows"
    # and returned to their owners by one small all_to_all of partial
    # output tiles.  {"a_tiles": [G, Bs, blk_h, blk_w],
    #   "col_ids_ext": [G, Bs*blk_w], "block_window"/"block_first": [G, Bs],
    #   "guest_cap": gcap, "pair_cap": qcap,
    #   "send_pos": [G, gcap] int32 (guest slot -> dest*qcap + lane;
    #                sentinel G*qcap = unused),
    #   "recv_row_idx": [G, G*qcap*blk_h] int32 (owner-local row of each
    #                incoming partial row; sentinel rows_per_shard = pad),
    #   "edge_pos": [G, Es] int32 (per real edge: flat cell position in the
    #                COMPUTING shard's split tile space; sentinel Bs*tile),
    #   "w_src":   [G, Es] int32 (matching slot into the all-gathered
    #                forward edge vector; sentinel G*Emax_fwd),
    #   "xa_fetch": [G, gcap*blk_h] int32 (guest slot row -> position in the
    #                owner-window-row all_to_all stack [G*qcap*blk_h];
    #                sentinel slots gather out of bounds -> zero)}
    split: Optional[dict] = None

    @property
    def padded_nodes(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def padded_edges(self) -> int:
        return self.num_shards * self.edge_capacity


def _pad_axis0(a: np.ndarray, target: int, fill) -> np.ndarray:
    if a.shape[0] == target:
        return a
    pad = np.full((target - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _tile_dtype(tiles_per_shard: list, config: TileConfig):
    """Structural-tile dtype shared by every stacked/overlap/split array.

    int8 like the single-device path (graph.py to_dev); if any shard holds
    a multigraph block whose duplicate-edge count exceeds int8 range, fall
    back to the compute dtype GLOBALLY so stacking stays homogeneous and no
    class silently wraps at 127."""
    if max(t.max(initial=0.0) for t in tiles_per_shard) <= 127:
        return np.int8
    import jax.numpy as jnp

    return (
        np.float32 if config.compute_dtype == jnp.float32 else config.compute_dtype
    )


def _stack_shards(
    metas: list[SGTMeta],
    edge_start: np.ndarray,
    num_nodes: int,
    num_edges: int,
    rows_per_shard: int,
    config: TileConfig,
    edge_capacity: Optional[int] = None,
    tiles_per_shard: Optional[list] = None,
) -> ShardedSGTMeta:
    from tcgnn.sgt.translate import build_a_tiles_host

    G = len(metas)
    blk_h, blk_w, ec = config.blk_h, config.blk_w, config.edge_chunk
    cn_max = max(m.num_chunks for m in metas)
    group = max(int(config.block_group), 1)
    b_max = -(-max(m.num_blocks for m in metas) // group) * group
    counts = np.diff(edge_start)
    e_max = int(edge_capacity if edge_capacity is not None else max(counts.max(), 1))
    last_window = rows_per_shard // config.blk_h - 1

    if tiles_per_shard is None:
        tiles_per_shard = [build_a_tiles_host(m) for m in metas]
    tile_np_dtype = _tile_dtype(tiles_per_shard, config)

    col_ids, chunk_r, chunk_c, chunk_eid = [], [], [], []
    chunk_block, chunk_window, chunk_first = [], [], []
    edge_perm, edge_valid = [], []
    a_tiles, block_window, block_first, edge_pos = [], [], [], []
    for s, m in enumerate(metas):
        e_s = int(counts[s])
        col_ids.append(_pad_axis0(m.col_ids, b_max * blk_w, 0))
        a_tiles.append(
            _pad_axis0(tiles_per_shard[s].astype(tile_np_dtype), b_max, 0)
        )
        # Cross-shard padding blocks: zero tiles, first=0, window = the
        # shard's LAST window.  The per-shard tiling already gives every
        # window >= 1 block (so block_window ends at last_window); padding
        # with last_window keeps the window map non-decreasing, which the
        # dense-tile Triton kernel relies on to find each window's blocks
        # as one contiguous range.
        block_window.append(_pad_axis0(m.block_window, b_max, last_window))
        block_first.append(_pad_axis0(m.block_first_in_window, b_max, 0))
        edge_pos.append(_pad_axis0(m.edge_pos.astype(np.int32), e_max, 0))
        # Padding chunks: all-sentinel rows -> zero one-hot -> zero
        # contribution; window = last window for the same output-map
        # monotonicity reason as the dense-path padding above.
        chunk_r.append(_pad_axis0(m.chunk_r, cn_max, config.row_sentinel))
        chunk_c.append(_pad_axis0(m.chunk_c, cn_max, 0))
        eid = m.chunk_edge_id.copy()
        eid[eid == m.num_edges] = e_max  # local pad sentinel -> Emax
        chunk_eid.append(_pad_axis0(eid, cn_max, e_max))
        chunk_block.append(_pad_axis0(m.chunk_block, cn_max, 0))
        chunk_window.append(_pad_axis0(m.chunk_window, cn_max, last_window))
        chunk_first.append(_pad_axis0(m.chunk_first_in_window, cn_max, 0))
        edge_perm.append(_pad_axis0(m.edge_perm, e_max, 0))
        valid = np.zeros(e_max, dtype=bool)
        valid[:e_s] = True
        edge_valid.append(valid)

    return ShardedSGTMeta(
        config=config,
        num_shards=G,
        num_nodes=num_nodes,
        num_edges=num_edges,
        rows_per_shard=rows_per_shard,
        windows_per_shard=rows_per_shard // config.blk_h,
        edge_capacity=e_max,
        num_real_blocks=sum(m.num_real_blocks for m in metas),
        edge_start=edge_start.astype(np.int64),
        col_ids=np.stack(col_ids),
        a_tiles=np.stack(a_tiles),
        block_window=np.stack(block_window),
        block_first_in_window=np.stack(block_first),
        edge_pos=np.stack(edge_pos),
        chunk_r=np.stack(chunk_r),
        chunk_c=np.stack(chunk_c),
        chunk_edge_id=np.stack(chunk_eid),
        chunk_block=np.stack(chunk_block),
        chunk_window=np.stack(chunk_window),
        chunk_first_in_window=np.stack(chunk_first),
        edge_perm=np.stack(edge_perm),
        edge_valid=np.stack(edge_valid),
    )


def build_split(
    metas: list,
    rows_per_shard: int,
    config: TileConfig,
    imbalance_gate: float = 1.3,
    tiles_per_shard: Optional[list] = None,
    edge_capacity: Optional[int] = None,
) -> Optional[dict]:
    """Mega-window block-stream split for the dense SpMM (both flavours).

    After a bandwidth ordering, hub windows hold most of a power-law
    graph's blocks (amazon0601 at 512x128: two windows carry 87% of 7024
    blocks), so no window→shard assignment can balance the mesh — the
    stacked grid is bounded below by max(window load). This pass splits
    the block *streams* of overloaded windows: the owner keeps the head,
    underloaded shards compute consecutive tail slices as appended "guest
    windows", and one all_to_all of partial [blk_h, d] output tiles
    returns guest sums to their owners (order-invariant float add; the
    kernel itself is unchanged — guests are just extra output windows).

    Slices are placed by **column affinity**: a window's condensed columns
    are rank-sorted, so a consecutive block slice covers a contiguous
    global column range — assigning it to the shard owning the majority of
    that range keeps most of the slice's feature gathers local (the halo
    request set is augmented with whatever is left).

    The split also carries per-edge maps (``edge_pos`` / ``w_src``) so the
    *weighted* SpMM rides the same balanced stream: guest blocks need the
    owner's per-edge scalars, and those are O(E) total — one ``all_gather``
    of the sharded edge vector (the transpose direction already pays it for
    forward-ordered weights) makes every edge weight visible everywhere,
    after which the computing shard scatters ``w_all[w_src]`` at
    ``edge_pos`` to build its split-stream weighted tiles on device.
    The fused tile-space AGNN rides the split as well: each guest slot's
    xa rows (the owner's window rows) arrive by one dedicated all_to_all
    driven by the same send_pos/recv_row_idx metadata (``xa_fetch`` below).
    Per-edge *outputs* (SDDMM scores) keep the unsplit stream: a score tile
    has no reduction, so returning guest scores would move as many bytes as
    the owner saved computing.

    Returns None when ``max shard load <= imbalance_gate * ideal`` (split
    not worth the exchange) — callers fall back to the plain dense path.
    Requires ``config.block_group == 1`` (the default; grouped streams
    would let one grid step straddle an owner/guest boundary).
    """
    from tcgnn.sgt.translate import build_a_tiles_host

    g = len(metas)
    blk_h, blk_w = config.blk_h, config.blk_w
    wd = rows_per_shard // blk_h
    if g <= 1 or config.block_group != 1:
        return None

    win_counts = [
        np.bincount(m.block_window, minlength=wd).astype(np.int64) for m in metas
    ]
    loads = np.array([int(c.sum()) for c in win_counts])
    total = int(loads.sum())
    ideal = -(-total // g)
    if loads.max() <= imbalance_gate * ideal:
        return None

    # --- choose exports: (owner, window, keep) triples ---------------------
    slack = max(ideal // 20, 1)
    cap = np.maximum(ideal + slack - loads, 0)
    exports = []  # (owner, window, lo, hi) block ranges (window-relative)
    for s in range(g):
        excess = int(loads[s] - ideal)
        if excess <= 0:
            continue
        for w in np.argsort(-win_counts[s], kind="stable"):
            if excess <= 0:
                break
            cnt = int(win_counts[s][w])
            keep = max(1, cnt - excess)
            if cnt - keep <= 0:
                continue
            exports.append((s, int(w), keep, cnt))
            excess -= cnt - keep
            loads[s] -= cnt - keep
    if not exports:
        return None

    # --- place consecutive slices on shards by column affinity -------------
    # parts[c]: list of (owner, window, blk_lo, blk_hi) computed by shard c.
    win_start = [np.cumsum(np.concatenate([[0], c[:-1]])) for c in win_counts]
    parts: list[list[tuple]] = [[] for _ in range(g)]
    for (o, w, keep, cnt) in exports:
        base = int(win_start[o][w])
        cols = metas[o].col_ids.reshape(-1, blk_w)
        b = keep
        while b < cnt:
            med = int(np.median(cols[base + b]))
            aff = min(med // rows_per_shard, g - 1)
            c = aff if (aff != o and cap[aff] > 0) else int(np.argmax(cap))
            if c == o or cap[c] <= 0:  # nothing left anywhere useful
                c = int(np.argmin(loads))
                if c == o:
                    break
            take = int(min(cnt - b, max(cap[c], 16)))
            parts[c].append((o, w, base + b, base + b + take))
            cap[c] -= take
            loads[c] += take
            b += take
    if not any(parts):
        return None
    for c in range(g):
        parts[c].sort()

    gcap = max(len(p) for p in parts)
    # lanes per ordered (computing c -> owner o) pair
    pair_n = np.zeros((g, g), np.int64)
    for c in range(g):
        for (o, _, _, _) in parts[c]:
            pair_n[c, o] += 1
    qcap = int(pair_n.max())

    exported = [np.zeros(int(c.sum()), bool) for c in win_counts]
    for c in range(g):
        for (o, _, lo, hi) in parts[c]:
            exported[o][lo:hi] = True

    # --- per-shard streams: own survivors + guest slices --------------------
    tiles_list = (
        tiles_per_shard
        if tiles_per_shard is not None
        else [build_a_tiles_host(m) for m in metas]
    )
    tdt = _tile_dtype(tiles_list, config)

    # Per-owner block remap for the per-edge maps below: which shard
    # computes each original block, and at which stream position.
    blk_comp = [np.full(int(c.sum()), -1, np.int64) for c in win_counts]
    blk_newpos = [np.full(int(c.sum()), -1, np.int64) for c in win_counts]

    a_tiles, col_ids, block_window, block_first = [], [], [], []
    send_pos = np.full((g, max(gcap, 1)), g * max(qcap, 1), np.int32)
    recv_row = np.full((g, g, max(qcap, 1)), rows_per_shard, np.int32)
    for c in range(g):
        keep_mask = ~exported[c]
        kept_idx = np.flatnonzero(keep_mask)
        blk_comp[c][kept_idx] = c
        blk_newpos[c][kept_idx] = np.arange(len(kept_idx))
        stream_off = len(kept_idx)
        t = [tiles_list[c][keep_mask].astype(tdt)]
        ci = [metas[c].col_ids.reshape(-1, blk_w)[keep_mask]]
        bw = [metas[c].block_window[keep_mask]]
        bf = [metas[c].block_first_in_window[keep_mask]]
        lane_used = np.zeros(g, np.int64)
        for j, (o, w, lo, hi) in enumerate(parts[c]):
            blk_comp[o][lo:hi] = c
            blk_newpos[o][lo:hi] = stream_off + np.arange(hi - lo)
            stream_off += hi - lo
            t.append(tiles_list[o][lo:hi].astype(tdt))
            ci.append(metas[o].col_ids.reshape(-1, blk_w)[lo:hi])
            bw.append(np.full(hi - lo, wd + j, np.int32))
            first = np.zeros(hi - lo, np.int32)
            first[0] = 1
            bf.append(first)
            lane = int(lane_used[o])
            lane_used[o] += 1
            send_pos[c, j] = o * qcap + lane
            recv_row[o, c, lane] = w * blk_h
        # zero-init unused guest slots so their output tiles are defined
        # before the (dropped) exchange read.
        for j in range(len(parts[c]), gcap):
            t.append(np.zeros((1, blk_h, blk_w), tdt))
            ci.append(np.zeros((1, blk_w), metas[c].col_ids.dtype))
            bw.append(np.full(1, wd + j, np.int32))
            bf.append(np.ones(1, np.int32))
        a_tiles.append(np.concatenate(t))
        col_ids.append(np.concatenate(ci).reshape(-1))
        block_window.append(np.concatenate(bw).astype(np.int32))
        block_first.append(np.concatenate(bf).astype(np.int32))

    bs = max(a.shape[0] for a in a_tiles)

    # --- per-edge maps for the weighted split stream ------------------------
    # For every real edge (owner o, local slot e): the flat position of its
    # tile cell in the COMPUTING shard's split stream, and the edge's global
    # padded-layout slot o*Emax+e (the index space of an all-gathered edge
    # vector; the transpose partition remaps w_src to forward slots in
    # partition_graph).  Sentinels: pos = bs*tile (scatter mode="drop"),
    # src = g*Emax (gathers the appended zero).
    tile = blk_h * blk_w
    e_max = int(edge_capacity) if edge_capacity is not None else max(
        max(m.num_edges for m in metas), 1
    )
    if bs * tile >= 2**31 or g * e_max >= 2**31:
        # The per-edge maps are int32; past this scale the dense path is
        # disabled anyway (per-shard dense index space / edge_fwd_slot are
        # int32 too) and the caller falls back to the chunk kernels.
        return None
    pos_lists: list[list] = [[] for _ in range(g)]
    src_lists: list[list] = [[] for _ in range(g)]
    for o in range(g):
        ep = metas[o].edge_pos.astype(np.int64)
        b = ep // tile
        comp = blk_comp[o][b]
        newpos = blk_newpos[o][b] * tile + ep % tile
        src = o * e_max + np.arange(len(ep), dtype=np.int64)
        for c in range(g):
            sel = comp == c
            pos_lists[c].append(newpos[sel])
            src_lists[c].append(src[sel])
    pos_cat = [np.concatenate(p) for p in pos_lists]
    src_cat = [np.concatenate(s) for s in src_lists]
    es = max(1, max(len(p) for p in pos_cat))
    edge_pos_split = np.full((g, es), bs * tile, np.int32)
    w_src = np.full((g, es), g * e_max, np.int32)
    for c in range(g):
        edge_pos_split[c, : len(pos_cat[c])] = pos_cat[c].astype(np.int32)
        w_src[c, : len(src_cat[c])] = src_cat[c].astype(np.int32)

    last = wd + max(gcap, 1) - 1
    split = {
        "a_tiles": np.stack([_pad_axis0(a, bs, 0) for a in a_tiles]),
        "col_ids": np.stack(
            [_pad_axis0(cil.reshape(-1, blk_w), bs, 0).reshape(-1) for cil in col_ids]
        ),
        "block_window": np.stack([_pad_axis0(b, bs, last) for b in block_window]),
        "block_first": np.stack([_pad_axis0(b, bs, 0) for b in block_first]),
        "guest_cap": gcap,
        "pair_cap": qcap,
        "send_pos": send_pos,
        "edge_pos": edge_pos_split,
        "w_src": w_src,
    }
    # The fused AGNN needs the xa side of a guest block's score tiles — the
    # OWNER's window rows.  Those are exactly the rows ``recv_row_idx``
    # describes, so the op fetches them with one dedicated all_to_all: each
    # owner sends x[recv_row_idx] (the window rows every (dest, lane) pair
    # wants), and guest slot j reads its blk_h rows at ``send_pos[j]*blk_h``
    # in the received [G*qcap*blk_h] stack.  ``xa_fetch`` is that gather
    # index; sentinel slots (send_pos = G*qcap) land out of bounds and
    # gather zeros — their tiles are zero so the rows never contribute.
    split["xa_fetch"] = (
        send_pos[:, :, None].astype(np.int64) * blk_h
        + np.arange(blk_h, dtype=np.int64)
    ).reshape(g, -1).astype(np.int32)
    # Expanded per-row targets for the owner-side scatter-add:
    # incoming lane (src c, lane l) row r -> recv_row[o, c, l] + r.
    rr = recv_row[:, :, :, None] + np.arange(blk_h, dtype=np.int32)
    rr = np.where(
        recv_row[:, :, :, None] >= rows_per_shard, rows_per_shard, rr
    )
    split["recv_row_idx"] = rr.reshape(g, -1).astype(np.int32)
    return split


def split_local_remote(
    meta: "SGTMeta",
    column_index: np.ndarray,
    lo: int,
    hi: int,
    config: TileConfig,
    tiles_full: Optional[np.ndarray] = None,
    tile_dtype=np.int8,
):
    """Split one shard's blocks into local / remote classes for halo overlap.

    A block is *local* iff every edge it holds references a column owned by
    this shard (``lo <= col < hi``) — its contribution needs only the
    shard-resident features, so the kernel can run while the halo
    all-gather is still in flight.  Edgeless padding blocks are local.

    Returns a dict per class with keys ``a_tiles`` (``tile_dtype``; the
    caller picks the same int8-or-compute dtype as the stacked tiles so
    multigraph counts never wrap), ``col_ids`` (local class: ids relative
    to the shard; remote: global), ``block_window``, ``block_first``,
    ``edge_pos`` ([num_edges] int64 into the class's tile space, -1 for
    edges of the other class), ``num_blocks``.
    """
    from tcgnn.sgt.translate import build_a_tiles_host

    blk_h, blk_w = config.blk_h, config.blk_w
    tile = blk_h * blk_w
    num_blocks = meta.num_blocks
    num_windows = meta.num_windows
    cols = np.asarray(column_index, dtype=np.int64)

    edge_block = meta.edge_pos // tile
    remote_edge = (cols < lo) | (cols >= hi)
    block_is_remote = np.zeros(num_blocks, dtype=bool)
    np.logical_or.at(block_is_remote, edge_block, remote_edge)

    if tiles_full is None:
        tiles_full = build_a_tiles_host(meta)
    tiles_full = tiles_full.astype(tile_dtype)
    block_start = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(meta.block_partition.astype(np.int64), out=block_start[1:])

    group = max(int(config.block_group), 1)
    out = {}
    for cls, sel in (("local", ~block_is_remote), ("remote", block_is_remote)):
        # per-window counts in this class, padded so every window owns >= 1
        # block (the class kernel must write every output tile) and rounded
        # up to the block-group size so a grid step never straddles windows
        # (mirrors _pad_blocks for the unsplit tiling).
        cls_per_window = np.add.reduceat(
            sel.astype(np.int64), block_start[:-1]
        ) if num_blocks else np.zeros(num_windows, np.int64)
        cls_per_window_p = -(-np.maximum(cls_per_window, 1) // group) * group
        new_start = np.zeros(num_windows + 1, dtype=np.int64)
        np.cumsum(cls_per_window_p, out=new_start[1:])
        nb = int(new_start[-1])

        # stable new index of each selected old block
        sel_idx = np.flatnonzero(sel)
        win_of_sel = meta.block_window[sel_idx].astype(np.int64)
        rank_in_window = (
            np.arange(len(sel_idx)) -
            np.concatenate([[0], np.cumsum(cls_per_window)])[win_of_sel]
        )
        new_block = np.full(num_blocks, -1, dtype=np.int64)
        new_block[sel_idx] = new_start[win_of_sel] + rank_in_window

        a_tiles = np.zeros((nb, blk_h, blk_w), dtype=tile_dtype)
        col_ids = np.zeros(nb * blk_w, dtype=np.int32)
        a_tiles[new_block[sel_idx]] = tiles_full[sel_idx]
        src_cols = meta.col_ids.reshape(num_blocks, blk_w)[sel_idx]
        col_ids.reshape(nb, blk_w)[new_block[sel_idx]] = src_cols

        block_window = np.repeat(
            np.arange(num_windows, dtype=np.int32), cls_per_window_p
        )
        block_first = np.zeros(nb, dtype=np.int32)
        block_first[new_start[:-1]] = 1

        e_sel = sel[edge_block]
        edge_pos = np.full(meta.num_edges, -1, dtype=np.int64)
        edge_pos[e_sel] = (
            new_block[edge_block[e_sel]] * tile + meta.edge_pos[e_sel] % tile
        )
        out[cls] = dict(
            a_tiles=a_tiles,
            col_ids=col_ids,
            block_window=block_window,
            block_first_in_window=block_first,
            edge_pos=edge_pos,
            num_blocks=nb,
        )

    # local class gathers from the shard-resident slab: rebase ids.
    lc = out["local"]["col_ids"].astype(np.int64) - lo
    out["local"]["col_ids"] = np.clip(lc, 0, hi - lo - 1).astype(np.int32)
    return out["local"], out["remote"]


def partition_streamed(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    num_shards: int,
    config: TileConfig = DEFAULT_CONFIG,
    edge_capacity: Optional[int] = None,
    max_chunks: Optional[int] = None,
    max_slab_rows: Optional[int] = None,
) -> dict:
    """Per-shard window-segment streamed chunk metadata (Reddit-scale).

    The one-shot stacked chunk layout (``partition_csr``) breaks past the
    chunk form's metadata / condensed-slab ceilings exactly like
    the single-device path does (``sgt/stream.py``); this builder runs
    the SAME window-segment streaming per shard and stacks the segment
    arrays ``[G, S, ...]`` with shard-uniform S / chunk / slab capacities
    (SPMD shard_map needs one static shape), so the distributed step
    lax.scans one compiled kernel over each shard's segments.

    Returns a dict of stacked numpy arrays + the uniform statics.
    ``max_chunks`` / ``max_slab_rows`` override the per-segment ceilings
    (tests force multi-segment streams on small graphs).
    """
    from tcgnn.sgt import stream as stream_lib

    mc = stream_lib.MAX_PREFETCH_CHUNKS if max_chunks is None else max_chunks
    msr = stream_lib.MAX_SLAB_ROWS if max_slab_rows is None else max_slab_rows
    blk_h = config.blk_h
    row_pointers = np.asarray(row_pointers, dtype=np.int64)
    column_index = np.asarray(column_index, dtype=np.int64)
    num_windows = max(_cdiv(num_nodes, blk_h), 1)
    wd = _cdiv(num_windows, num_shards)
    rows_per_shard = wd * blk_h
    n_pad = num_shards * rows_per_shard
    ptr = np.concatenate(
        [row_pointers,
         np.full(n_pad + 1 - len(row_pointers), row_pointers[-1], np.int64)]
    )
    edge_start = ptr[::rows_per_shard].copy()

    metas = []
    for s in range(num_shards):
        r0, r1 = s * rows_per_shard, (s + 1) * rows_per_shard
        metas.append(sparse_graph_translate(
            ptr[r0:r1 + 1] - ptr[r0], column_index[ptr[r0]:ptr[r1]],
            rows_per_shard, config, emit_chunks=True, build_tiles=False,
        ))

    # Agree on shard-uniform segmentation: max natural S, then the maxima
    # of the per-shard capacities at that S.
    plans = [
        stream_lib.segment_chunks(
            m, max_chunks=mc, max_slab_rows=msr, plan_only=True
        )
        for m in metas
    ]
    S = max(p[0] for p in plans)
    plans = [
        stream_lib.segment_chunks(m, num_segments=S, plan_only=True)
        for m in metas
    ]
    c_max = max(p[2] for p in plans)
    b_max = max(p[3] for p in plans)
    smetas = [
        stream_lib.segment_chunks(
            m, num_segments=S, pad_chunks_to=c_max, pad_slab_blocks_to=b_max,
            to_device=False,
        )
        for m in metas
    ]

    counts = np.diff(edge_start)
    e_max = int(
        edge_capacity if edge_capacity is not None else max(counts.max(), 1)
    )
    G = num_shards
    perm_dtype = np.int64 if S * c_max * config.edge_chunk >= 2**31 else np.int32
    edge_perm = np.zeros((G, e_max), perm_dtype)
    edge_valid = np.zeros((G, e_max), bool)
    out = {k: [] for k in stream_lib._S_ARRAY_FIELDS if k != "edge_perm"}
    for s, sm in enumerate(smetas):
        for k in out:
            out[k].append(np.asarray(getattr(sm, k)))
        ep = np.asarray(sm.edge_perm)
        edge_perm[s, : len(ep)] = ep
        edge_valid[s, : len(ep)] = True
    arrays = {k: np.stack(v) for k, v in out.items()}
    arrays["edge_perm"] = edge_perm
    arrays["edge_valid"] = edge_valid
    return {
        "arrays": arrays,
        "wseg": int(smetas[0].wseg),
        "num_segments": int(S),
        "rows_per_shard": rows_per_shard,
        "windows_per_shard": wd,
        "edge_capacity": e_max,
        "edge_start": edge_start.astype(np.int64),
        "num_real_blocks": sum(m.num_real_blocks for m in metas),
    }


def plan_halo_rounds(
    pair_counts,
    *,
    target_overhead: float = 1.2,
    slack_rows: int = 64,
    max_rounds_per_offset: int = 16,
):
    """Quantized partial-pair exchange schedule over the pair matrix.

    Per owner offset o, a single cyclic ppermute must pad every pair to
    the offset's max pair count — and one heavy-requester shard (hub
    windows reference many remote uniques) drives EVERY offset's max,
    keeping the wire 3-6x the ideal boundary on the AE graphs.  Instead
    each offset's exchange is split into ROUNDS of quantum Q: round j
    moves segment rows [j*Q, j*Q+size) and lists ONLY the pairs still
    owing rows (``ppermute`` with partial source_target_pairs moves
    nothing on unlisted links).  Light pairs ride one round; the heavy
    pair rides them all; per-pair padding drops from cap-p to <Q.  Q is
    the largest halving of the offset's cap whose scheduled wire volume
    is within ``target_overhead`` of the offset's ideal (+``slack_rows``
    per pair), bounded by ``max_rounds_per_offset``.

    Returns ``(offset_caps, rounds, halo_rows)`` where rounds is a tuple
    of ``(pos, size, pairs)`` — ``pos`` the row offset into the send
    table / halo slab, ``pairs`` a tuple of (src, dst) device pairs.
    """
    G = len(pair_counts)
    offset_caps = []
    rounds = []
    pos = 0
    for o in range(1, G):
        # p[s] = rows requester s pulls from its offset-o owner (s+o)%G.
        p = [int(pair_counts[s][(s + o) % G]) for s in range(G)]
        cap = max(p)
        if cap == 0:
            continue
        ideal = sum(p)
        budget = target_overhead * ideal + slack_rows * sum(
            1 for pi in p if pi
        )

        def schedule(q):
            sizes = []
            start = 0
            while start < cap:
                sizes.append(min(q, cap - start))
                start += q
            wire = sum(
                sz * sum(1 for pi in p if pi > j * q)
                for j, sz in enumerate(sizes)
            )
            return sizes, wire

        q = cap
        while True:
            sizes, wire = schedule(q)
            if wire <= budget or len(sizes) * 2 > max_rounds_per_offset:
                break
            q = -(-q // 2)
        for j, sz in enumerate(sizes):
            pairs = tuple(
                ((s + o) % G, s) for s in range(G) if p[s] > j * q
            )
            rounds.append((pos + j * q, sz, pairs))
        offset_caps.append((o, cap))
        pos += cap
    return tuple(offset_caps), tuple(rounds), pos


def build_halo(
    local_cols_list: list[np.ndarray],
    col_ids_stacked: np.ndarray,
    overlap_remote_col_ids: Optional[np.ndarray],
    num_shards: int,
    rows_per_shard: int,
    extra_cols_list: Optional[list] = None,
    split_col_ids: Optional[np.ndarray] = None,
) -> dict:
    """Boundary-only halo structures for the distributed ops.

    For each shard s, the *remote set* is the sorted unique global column
    ids its edges reference outside its own row range.  The exchange is a
    sequence of cyclic ``ppermute``s, one per owner OFFSET o in
    ``offset_caps`` (requester s pulls from owner (s+o)%G), each padded to
    that offset's max pair count only.  Slot assignment in the extended
    slab ``[rows_per_shard + halo_rows]``: remote node owned by shard t at
    rank p of s's request lives at ``rows_per_shard + seg_start[(t-s)%G]
    + p``.  ``send_idx[t]`` concatenates, per offset segment, t's local
    rows destined for its offset-o receiver (0-padded; padded slots land
    in halo positions no col_id references).

    Padding col_ids (structural zeros) that are not real columns of the
    shard remap to local slot 0 — their tile entries are zero, so the
    gathered row never contributes.
    """
    G = num_shards
    requests = []  # requests[s][t]: sorted unique ids owned by t, needed by s
    for s in range(G):
        lo, hi = s * rows_per_shard, (s + 1) * rows_per_shard
        cols = np.asarray(local_cols_list[s], np.int64)
        if extra_cols_list is not None and len(extra_cols_list[s]):
            # guest-window columns (build_split): the shard gathers them
            # even though it owns none of their rows.
            cols = np.concatenate([cols, np.asarray(extra_cols_list[s], np.int64)])
        cols = np.unique(cols)
        remote = cols[(cols < lo) | (cols >= hi)]
        owner = remote // rows_per_shard
        requests.append([remote[owner == t] for t in range(G)])

    # Per (requesting, owning) shard pair: rows moved by the halo
    # exchange — the measured-traffic ground truth (comm_stats /
    # two-level-mesh DCN accounting reads this).
    pair_counts = np.array(
        [[len(requests[s][t]) for t in range(G)] for s in range(G)],
        np.int64,
    )
    H = max((len(r) for reqs in requests for r in reqs), default=0)
    H = max(int(H), 1)

    # Quantized partial-pair ppermute schedule (plan_halo_rounds): per
    # owner offset o the slab segment is that offset's max pair count,
    # and the exchange over it runs in partial-pair rounds so light
    # pairs stop sending once their rows are delivered — not one
    # all_to_all padded to the GLOBAL max pair count, which measured
    # 1.3-6.8x the ideal boundary bytes on the AE graphs (round-4
    # comm_measured.csv).  Offsets no shard uses are skipped entirely
    # (banded/RCM graphs exchange only with near neighbors).
    offset_caps, rounds, halo_rows = plan_halo_rounds(pair_counts)
    seg_start = {}
    run = 0
    for o, c in offset_caps:
        seg_start[o] = run
        run += c

    # send_idx[t]: concatenation over offsets o of the local rows shard t
    # sends to its offset-o receiver s=(t-o)%G (that receiver's request
    # list), 0-padded to cap_o per segment (padded slots land in halo
    # positions no col_id references).
    send_idx = np.zeros((G, max(halo_rows, 1)), np.int32)
    for t in range(G):
        for o, cap in offset_caps:
            s = (t - o) % G
            r = requests[s][t]
            p0 = seg_start[o]
            send_idx[t, p0 : p0 + len(r)] = (
                r - t * rows_per_shard
            ).astype(np.int32)

    # Per-shard remap tables: concatenating per-owner request lists over
    # ascending owners yields a globally sorted id list (owner t's ids live
    # in [t*rows, (t+1)*rows)), so one searchsorted remaps any column array.
    # Slot of owner t's rank-p id for requester s: the offset-(t-s)%G
    # segment of the halo tail, position p.
    def make_remap(s):
        ids = np.concatenate([requests[s][t] for t in range(G)]) if G else np.empty(0, np.int64)
        slots = np.concatenate(
            [
                rows_per_shard
                + seg_start.get((t - s) % G, 0)
                + np.arange(len(requests[s][t]), dtype=np.int64)
                for t in range(G)
            ]
        ) if G else np.empty(0, np.int64)
        lo, hi = s * rows_per_shard, (s + 1) * rows_per_shard

        def remap(col_arr):
            c = np.asarray(col_arr, np.int64)
            local = (c >= lo) & (c < hi)
            out = np.where(local, c - lo, 0)
            if len(ids):
                pos = np.searchsorted(ids, c)
                pos_c = np.minimum(pos, len(ids) - 1)
                hit = (~local) & (ids[pos_c] == c)
                out = np.where(hit, slots[pos_c], out)
            return out.astype(np.int32)

        return remap

    remaps = [make_remap(s) for s in range(G)]
    col_ids_ext = np.stack(
        [remaps[s](col_ids_stacked[s]) for s in range(G)]
    )
    ov_ext = None
    if overlap_remote_col_ids is not None:
        ov_ext = np.stack(
            [remaps[s](overlap_remote_col_ids[s]) for s in range(G)]
        )
    sp_ext = None
    if split_col_ids is not None:
        sp_ext = np.stack([remaps[s](split_col_ids[s]) for s in range(G)])
    return {
        "capacity": H,
        "offset_caps": offset_caps,
        "rounds": rounds,
        "halo_rows": halo_rows,
        "send_idx": send_idx,
        "col_ids_ext": col_ids_ext,
        "overlap_remote_col_ids_ext": ov_ext,
        "split_col_ids_ext": sp_ext,
        "pair_counts": pair_counts,
    }


def partition_csr(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    num_shards: int,
    config: TileConfig = DEFAULT_CONFIG,
    edge_capacity: Optional[int] = None,
    build_tiles: bool = True,
    split: bool = False,
) -> ShardedSGTMeta:
    """Window-aligned 1-D partition of a CSR adjacency over ``num_shards``.

    Each shard's rows are tiled independently with the standard SGT pass —
    identical math to the single-device tiling because windows never cross
    shard boundaries.

    ``build_tiles=False`` returns a LIGHT layout-only meta (shapes, edge
    offsets, block stats; every stacked array is None) for callers that
    serve the ops elsewhere — the distributed block-diagonal path — and
    would otherwise pay gigabytes of host tile materialization (per-shard
    dense a_tiles, overlap split, halo tables) just to throw it away.
    """
    blk_h = config.blk_h
    row_pointers = np.asarray(row_pointers, dtype=np.int64)
    column_index = np.asarray(column_index, dtype=np.int64)
    num_edges = int(column_index.shape[0])

    num_windows = max(_cdiv(num_nodes, blk_h), 1)
    wd = _cdiv(num_windows, num_shards)
    rows_per_shard = wd * blk_h
    n_pad = num_shards * rows_per_shard

    ptr = np.concatenate(
        [row_pointers, np.full(n_pad + 1 - len(row_pointers), row_pointers[-1], np.int64)]
    )
    edge_start = ptr[:: rows_per_shard].copy()  # [G+1]

    metas, local_cols_list = [], []
    for s in range(num_shards):
        r0, r1 = s * rows_per_shard, (s + 1) * rows_per_shard
        local_ptr = ptr[r0 : r1 + 1] - ptr[r0]
        local_cols = column_index[ptr[r0] : ptr[r1]]
        local_cols_list.append(local_cols)
        metas.append(
            sparse_graph_translate(
                local_ptr, local_cols, rows_per_shard, config,
                emit_chunks=build_tiles, build_tiles=False,
            )
        )

    if not build_tiles:
        counts = np.diff(edge_start)
        e_max = int(
            edge_capacity if edge_capacity is not None else max(counts.max(), 1)
        )
        return ShardedSGTMeta(
            config=config,
            num_shards=num_shards,
            num_nodes=num_nodes,
            num_edges=num_edges,
            rows_per_shard=rows_per_shard,
            windows_per_shard=rows_per_shard // blk_h,
            edge_capacity=e_max,
            num_real_blocks=sum(m.num_real_blocks for m in metas),
            edge_start=edge_start.astype(np.int64),
            col_ids=None, a_tiles=None, block_window=None,
            block_first_in_window=None, edge_pos=None, chunk_r=None,
            chunk_c=None, chunk_edge_id=None, chunk_block=None,
            chunk_window=None, chunk_first_in_window=None, edge_perm=None,
            edge_valid=None,
        )

    from tcgnn.sgt.translate import build_a_tiles_host

    tiles_per_shard = [build_a_tiles_host(m) for m in metas]
    stacked = _stack_shards(
        metas, edge_start, num_nodes, num_edges, rows_per_shard, config,
        edge_capacity, tiles_per_shard=tiles_per_shard,
    )
    stacked.overlap = _stack_overlap(
        metas, local_cols_list, rows_per_shard, config, stacked.edge_capacity,
        tiles_per_shard=tiles_per_shard,
    )
    split_host = (
        build_split(
            metas, rows_per_shard, config, tiles_per_shard=tiles_per_shard,
            edge_capacity=stacked.edge_capacity,
        )
        if split
        else None
    )
    stacked.halo = build_halo(
        local_cols_list,
        stacked.col_ids,
        stacked.overlap["remote"]["col_ids"] if stacked.overlap else None,
        num_shards,
        rows_per_shard,
        extra_cols_list=(
            [split_host["col_ids"][s] for s in range(num_shards)]
            if split_host is not None
            else None
        ),
        split_col_ids=split_host["col_ids"] if split_host is not None else None,
    )
    if split_host is not None:
        split_host["col_ids_ext"] = stacked.halo.pop("split_col_ids_ext")
        # keep the global-id view (host only; tests run per-shard ops
        # against the full slab)
        split_host["col_ids_global"] = split_host.pop("col_ids")
        stacked.split = split_host
    else:
        stacked.halo.pop("split_col_ids_ext", None)
    return stacked


def _stack_overlap(
    metas, local_cols_list, rows_per_shard, config, edge_capacity,
    tiles_per_shard=None,
):
    """Stack per-shard local/remote block classes (see split_local_remote).

    Each class also carries ``edge_pos`` [G, edge_capacity]: the edge's flat
    slot in the CLASS's tile space, with edges of the other class (and
    capacity padding) pointing one-past-the-end — an out-of-bounds sentinel
    that scatter ``mode="drop"`` ignores and gather ``mode="fill"`` zeroes,
    so the weighted/SDDMM overlap ops need no extra masks.
    """
    tdt = (
        _tile_dtype(tiles_per_shard, config)
        if tiles_per_shard is not None
        else np.int8
    )
    classes = {"local": [], "remote": []}
    for s, m in enumerate(metas):
        lo, hi = s * rows_per_shard, (s + 1) * rows_per_shard
        loc, rem = split_local_remote(
            m, local_cols_list[s], lo, hi, config,
            tiles_full=tiles_per_shard[s] if tiles_per_shard is not None else None,
            tile_dtype=tdt,
        )
        classes["local"].append(loc)
        classes["remote"].append(rem)

    group = max(int(config.block_group), 1)
    tile = config.blk_h * config.blk_w
    # Cross-shard padding blocks target the LAST window (same output-map
    # monotonicity requirement as _stack_shards).
    last_window = rows_per_shard // config.blk_h - 1
    out = {}
    for cls, parts in classes.items():
        b_max = -(-max(p["num_blocks"] for p in parts) // group) * group
        sentinel = b_max * tile
        assert sentinel + 1 < 2**31, (cls, b_max)
        epos = np.full((len(parts), edge_capacity), sentinel, dtype=np.int32)
        for s, p in enumerate(parts):
            e = p["edge_pos"]
            epos[s, : len(e)] = np.where(e < 0, sentinel, e).astype(np.int32)
        out[cls] = {
            "a_tiles": np.stack(
                [_pad_axis0(p["a_tiles"], b_max, 0) for p in parts]
            ),
            "col_ids": np.stack(
                [_pad_axis0(p["col_ids"], b_max * config.blk_w, 0) for p in parts]
            ),
            "block_window": np.stack(
                [_pad_axis0(p["block_window"], b_max, last_window) for p in parts]
            ),
            "block_first_in_window": np.stack(
                [_pad_axis0(p["block_first_in_window"], b_max, 0) for p in parts]
            ),
            "edge_pos": epos,
        }
    return out


def partition_graph(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    num_shards: int,
    config: TileConfig = DEFAULT_CONFIG,
    symmetric: bool = False,
    build_tiles: bool = True,
    split: bool = False,
    transpose: Optional[tuple] = None,
) -> tuple[ShardedSGTMeta, ShardedSGTMeta]:
    """Forward + transpose sharded metadata for distributed training.

    ``transpose``: optional precomputed ``(t_ptr, t_idx, t_src)`` for this
    exact CSR (probe_block_diag already paid the O(E) host transpose).

    The transpose partition carries ``chunk_fwd_slot`` so per-edge weights
    given in forward CSR order can be fetched (post all-gather) inside the
    backward SpMM.  As in :class:`tcgnn.graph.TiledGraph`, the explicit
    transpose keeps gradients exact on directed graphs where the reference
    silently assumes symmetry (``TCGNN.cpp:270``).
    """
    fwd = partition_csr(
        row_pointers, column_index, num_nodes, num_shards, config,
        build_tiles=build_tiles, split=split,
    )

    t_ptr, t_idx, t_src = (
        transpose
        if transpose is not None
        else transpose_csr(
            np.asarray(row_pointers), np.asarray(column_index), num_nodes
        )
    )
    bwd = partition_csr(
        t_ptr, t_idx, num_nodes, num_shards, config, build_tiles=build_tiles,
        split=split,
    )

    # Map each transpose chunk slot -> forward padded-layout slot.
    G, e_max_t = bwd.num_shards, bwd.edge_capacity
    e_max_f = fwd.edge_capacity
    sentinel = G * e_max_f

    fwd_slot_of_global = np.empty(fwd.num_edges + 1, dtype=np.int64)
    for s in range(G):
        lo, hi = fwd.edge_start[s], fwd.edge_start[s + 1]
        fwd_slot_of_global[lo:hi] = s * e_max_f + np.arange(hi - lo)
    fwd_slot_of_global[fwd.num_edges] = sentinel

    # local t-edge id -> global t-edge -> forward global edge -> fwd slot.
    t_src_ext = np.concatenate([t_src.astype(np.int64), [fwd.num_edges]])
    if build_tiles:
        chunk_fwd_slot = np.empty_like(bwd.chunk_edge_id)
        for s in range(G):
            local = bwd.chunk_edge_id[s].astype(np.int64)  # sentinel = e_max_t
            global_t = np.where(
                local == e_max_t, len(t_src), bwd.edge_start[s] + local
            )
            chunk_fwd_slot[s] = fwd_slot_of_global[t_src_ext[global_t]].astype(np.int32)
        bwd.chunk_fwd_slot = chunk_fwd_slot

    # Transpose split stream: its w_src indexes the TRANSPOSE padded edge
    # layout, but weights arrive forward-ordered — remap each t-slot through
    # t_src to the forward padded slot so the split fn can gather from the
    # same all-gathered forward edge vector in both directions.
    if bwd.split is not None:
        src = bwd.split["w_src"].astype(np.int64)
        s_idx = np.minimum(src // e_max_t, G - 1)
        global_t = np.where(
            src >= G * e_max_t, len(t_src), bwd.edge_start[s_idx] + src % e_max_t
        )
        bwd.split["w_src"] = fwd_slot_of_global[t_src_ext[global_t]].astype(
            np.int32
        )

    # Dense-path variant: the same mapping per *edge* instead of per chunk
    # slot (feeds the weighted-tile scatter in the distributed backward).
    t_counts = np.diff(bwd.edge_start)
    edge_fwd_slot = np.full((G, e_max_t), sentinel, dtype=np.int32)
    for s in range(G):
        cnt = int(t_counts[s])
        global_t = bwd.edge_start[s] + np.arange(cnt, dtype=np.int64)
        edge_fwd_slot[s, :cnt] = fwd_slot_of_global[
            t_src.astype(np.int64)[global_t]
        ].astype(np.int32)
    bwd.edge_fwd_slot = edge_fwd_slot
    return fwd, bwd
