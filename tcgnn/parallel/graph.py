"""DistributedTiledGraph: multi-device SGT graph with shard_map'ed ops.

The reference framework is single-GPU with no distributed layer at all
(SURVEY.md §2.3); this module is additive scope.  Design:

* **mesh** ``('graph', 'feature')`` — ``graph`` shards row windows (nodes,
  edges, outputs), ``feature`` shards the embedding dimension (the mesh-level
  generalization of the per-warp dim tile in
  ``/root/reference/TCGNN_conv/TCGNN_kernel.cu:355``).
* **halo exchange** — each shard aggregates rows it owns but reads neighbor
  features owned by any shard.  The GPU kernel's shared-memory gather
  (``TCGNN_kernel.cu:415-427``) becomes a *boundary-only* exchange over the
  ``graph`` axis: request lists computed at partition time
  (``partition.build_halo``), exchanged by quantized partial-pair
  ``ppermute`` rounds (``partition.plan_halo_rounds`` — per owner offset,
  rounds of quantum Q listing only the pairs still owing rows), kernels
  gathering from a compact ``[rows_per_shard + halo_rows]`` extended
  slab.  Per-device feature memory is O(N/G + boundary) and the wire
  volume sits within ~1.25× of the exact per-pair boundary — not O(N·d)
  — and XLA overlaps the async collectives with the local-block compute
  (see the overlap split).  The chunk fallback keeps the simpler full
  all_gather, and Reddit-class shards auto-route to the distributed
  STREAMED composition (``_build_ops_streamed``: per-shard window
  segments scanned inside the shard map).
* **per-edge vectors** (SDDMM scores, attention weights) are
  ``[G * edge_capacity]`` arrays sharded on ``graph`` — a shard's edges are
  the contiguous CSR slice of its rows, so no reshuffling is needed between
  SDDMM and the weighted SpMM of the same AGNN layer.
* **backward** — explicit transpose partitioning (not the reference's
  symmetric-adjacency alias, ``TCGNN.cpp:270``); weights given in forward
  edge order are fetched post-all-gather through precomputed
  ``chunk_fwd_slot`` tables.
* **load balance** — the stacked metadata pads every shard to the heaviest
  shard's block count, so every shard processes Bmax blocks per op. Two
  levers keep Bmax near total/G: the window-granular LPT relabeling
  (``sgt.reorder.shard_balance_permutation``, applied by
  ``distributed_graph_from_dataset``) for flat block distributions
  (reddit: 1.75x), and the mega-window block-stream split
  (``partition.build_split``) for hub-dominated ones (amazon class: 3.3x)
  — underloaded shards compute consecutive tail slices of overloaded
  windows as guest output windows, placed by column affinity, and one
  small all_to_all of partial [blk_h, d] tiles returns them to their
  owners.  Both SpMM flavours ride the split stream: the weighted one
  rebuilds its tiles on the computing shard from an all-gathered edge
  vector via the per-edge ``edge_pos``/``w_src`` maps.  The fused
  tile-space AGNN rides it too — guest score tiles need the owner's
  window rows on their xa side, delivered by one dedicated all_to_all
  driven by the same send_pos/recv_row_idx metadata (``xa_fetch``), so
  the shared halo capacity is untouched.  Per-edge outputs
  (SDDMM) keep the unsplit stream — score tiles have no reduction, so a
  guest exchange would move as many bytes as it saves.

The public op surface (``spmm``, ``spmm_weighted``, ``sddmm``) matches
:class:`tcgnn.graph.TiledGraph`, so the model layers in
``tcgnn/models`` run unchanged on a mesh.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tcgnn.config import DEFAULT_CONFIG, TileConfig
from tcgnn.ops.spmm import (
    _spmm_dense_padded,
    _spmm_fused_padded,
    _spmm_padded,
    _spmm_sfused_bwd_padded,
    _spmm_sfused_padded,
    _precision,
)
from tcgnn.ops.sddmm import _sddmm_dense_padded, _sddmm_padded
from tcgnn.parallel.partition import ShardedSGTMeta, partition_graph


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _is_symmetric(row_pointers, column_index, num_nodes: int, t=None) -> bool:
    """Symmetric-adjacency detection (same check as TiledGraph): enables
    the fused tile-space AGNN path, whose transpose-side gradient reuses
    the forward shard tiling.  ``t=(t_ptr, t_idx)`` reuses a precomputed
    transpose."""
    if t is None:
        from tcgnn.sgt.translate import transpose_csr

        t_ptr, t_idx, _ = transpose_csr(
            np.asarray(row_pointers), np.asarray(column_index), num_nodes
        )
    else:
        t_ptr, t_idx = t
    return bool(
        len(t_ptr) == len(row_pointers)
        and np.array_equal(np.asarray(t_ptr, np.int64), np.asarray(row_pointers, np.int64))
        and np.array_equal(np.asarray(t_idx, np.int64), np.asarray(column_index, np.int64))
    )


def probe_block_diag(
    row_pointers, column_index, num_nodes: int, num_shards: int,
    config: TileConfig = DEFAULT_CONFIG,
):
    """Gate for the distributed block-diagonal fast path.

    Fully-covered banded/component graphs shard by contiguous bin ranges
    and serve every op from packed diagonal tiles with a nearest-neighbor
    ppermute rim halo — no condensed tiles, no index-driven exchange
    (``parallel/blockdiag.py``).  Probed BEFORE partitioning so the light
    layout-only partition (``build_tiles=False``) skips the per-shard
    dense tile / overlap / halo materialization the BD path would throw
    away.  Shared by :class:`DistributedTiledGraph` and
    :func:`distributed_graph_from_dataset` (which must NOT window-balance
    a graph headed for the BD path — the balance shuffle destroys the
    banded layout).

    Returns ``(ok, bdm, bdm_t, symmetric, (t_ptr, t_idx, t_src))`` — the
    transpose triple is valid for the PROBED CSR and lets the constructor
    skip partition_graph's O(E) re-transpose when the CSR is unchanged.
    """
    from tcgnn.sgt.blockdiag import extract_block_diag
    from tcgnn.sgt.translate import transpose_csr

    n = int(num_nodes)
    blk_h = config.blk_h
    wd = _round_up(max(-(-n // blk_h), 1), num_shards) // num_shards
    rows_per_shard = wd * blk_h  # == partition_csr's derivation

    t_ptr, t_idx, t_src = transpose_csr(
        np.asarray(row_pointers), np.asarray(column_index), n
    )
    symmetric = _is_symmetric(row_pointers, column_index, n, t=(t_ptr, t_idx))

    bdm = extract_block_diag(row_pointers, column_index, n)
    bdm_t = (
        bdm if (symmetric or bdm is None) else extract_block_diag(t_ptr, t_idx, n)
    )

    def _ok(m):
        if m is None or m.coverage < 1.0:
            return False
        if rows_per_shard % m.bin_rows:
            return False
        b_loc = rows_per_shard // m.bin_rows
        # Rim halo reaches one neighbor shard; pack slots fit int32.
        return (
            max(abs(k) for k in m.offsets) <= b_loc
            and len(m.offsets) * b_loc * m.bin_rows**2 + 1 < 2**31
        )

    return _ok(bdm) and _ok(bdm_t), bdm, bdm_t, symmetric, (t_ptr, t_idx, t_src)


def _shards_need_streaming(
    row_pointers, column_index, num_nodes, num_shards, config
) -> bool:
    """Cheap routing probe: would any shard's one-shot chunk metadata
    exceed the chunk or condensed-slab ceilings
    (``sgt.stream.needs_streaming``'s limits, applied per shard)?"""
    from tcgnn.sgt import native
    from tcgnn.sgt.stream import MAX_PREFETCH_CHUNKS, MAX_SLAB_ROWS

    blk_h = config.blk_h
    ptr = np.asarray(row_pointers, np.int64)
    n_windows = max(-(-num_nodes // blk_h), 1)
    wd = -(-n_windows // num_shards)
    rows_per_shard = wd * blk_h
    n_pad = num_shards * rows_per_shard
    ptr = np.concatenate(
        [ptr, np.full(n_pad + 1 - len(ptr), ptr[-1], np.int64)]
    )
    cols = np.asarray(column_index)
    for s in range(num_shards):
        r0, r1 = s * rows_per_shard, (s + 1) * rows_per_shard
        e_s = int(ptr[r1] - ptr[r0])
        # Chunk count is at least edges/EC + one initializing chunk per
        # window — an estimate is enough for routing (borderline graphs
        # are valid on either path).
        if e_s // config.edge_chunk + wd > MAX_PREFETCH_CHUNKS:
            return True
        # Block count can never exceed ceil(E_s/blk_w) + one per window:
        # when even that bound fits the slab, skip the native counting
        # pass entirely (it is an O(E) host pass partition_csr's translate
        # repeats anyway — only borderline-big shards pay it).
        blocks_ub = -(-e_s // config.blk_w) + wd
        if blocks_ub * config.blk_w <= MAX_SLAB_ROWS:
            continue
        if native.available() and e_s:
            blocks = int(np.sum(native.count_blocks(
                np.ascontiguousarray(ptr[r0:r1 + 1] - ptr[r0]),
                np.ascontiguousarray(cols[ptr[r0]:ptr[r1]], np.int32),
                blk_h, config.blk_w,
            )))
            if blocks * config.blk_w > MAX_SLAB_ROWS:
                return True
    return False


# Distributed streamed path (per-shard window segments, sgt/stream.py).
_STREAM_FIELDS = (
    "seg_col_ids", "seg_r", "seg_c", "seg_edge_id",
    "seg_block", "seg_window", "seg_first", "edge_perm", "edge_valid",
)


_META_FIELDS = (
    "col_ids",
    "chunk_r",
    "chunk_c",
    "chunk_edge_id",
    "chunk_block",
    "chunk_window",
    "chunk_first_in_window",
    "edge_perm",
    "edge_valid",
)

# Dense-tile path (the default; chunk fields remain the fallback).
# ``col_ids_ext`` indexes the boundary-halo extended slab (see
# partition.build_halo) — the dense kernels never see global node ids.
_DENSE_FIELDS = (
    "a_tiles",
    "col_ids_ext",
    "block_window",
    "block_first_in_window",
    "edge_pos",
    "edge_valid",
    "send_idx",
)


_OVERLAP_KEYS = (
    "a_tiles", "col_ids", "block_window", "block_first_in_window", "edge_pos"
)


# Mega-window block-stream split (partition.build_split): guest windows are
# appended output slots; send_pos/recv_row_idx drive the partial-tile
# all_to_all back to the owners.  edge_pos/w_src rebuild the split stream's
# weighted tiles from an all-gathered forward edge vector.
_SPLIT_FIELDS = (
    "a_tiles", "col_ids_ext", "block_window", "block_first",
    "send_pos", "recv_row_idx", "edge_pos", "w_src", "xa_fetch",
    "send_idx",
)


def _meta_to_device(
    meta: ShardedSGTMeta, mesh: Mesh, with_fwd_slot: bool, dense: bool = True
) -> dict:
    """Upload exactly the arrays the chosen op path reads.

    The dense path never touches the chunk metadata or the global
    ``col_ids`` (its kernels index the halo-remapped ``col_ids_ext``), and
    the chunk fallback never touches the dense tiles, halo tables, overlap
    classes, or split streams — uploading the union would waste tens of
    MB of transfer and device memory per big graph.
    """
    sh = NamedSharding(mesh, P("graph"))
    fields = (
        set(_DENSE_FIELDS) - {"col_ids_ext", "send_idx"}
        if dense
        else set(_META_FIELDS)
    )
    out = {
        k: jax.device_put(jnp.asarray(getattr(meta, k)), sh) for k in fields
    }
    if dense:
        out["col_ids_ext"] = jax.device_put(
            jnp.asarray(meta.halo["col_ids_ext"]), sh
        )
        out["send_idx"] = jax.device_put(jnp.asarray(meta.halo["send_idx"]), sh)
    if with_fwd_slot:
        if dense:
            out["edge_fwd_slot"] = jax.device_put(
                jnp.asarray(meta.edge_fwd_slot), sh
            )
        else:
            out["chunk_fwd_slot"] = jax.device_put(
                jnp.asarray(meta.chunk_fwd_slot), sh
            )
    if dense and meta.overlap is not None:
        ov = {cls: dict(meta.overlap[cls]) for cls in ("local", "remote")}
        ov["remote"]["col_ids"] = meta.halo["overlap_remote_col_ids_ext"]
        out["overlap"] = tuple(
            jax.device_put(jnp.asarray(ov[cls][k]), sh)
            for cls in ("local", "remote")
            for k in _OVERLAP_KEYS
        )
    if dense and meta.split is not None:
        sp = meta.split
        # everything but send_idx, which _device_arrays appends last
        out["split"] = tuple(
            jax.device_put(jnp.asarray(sp[k]), sh) for k in _SPLIT_FIELDS[:-1]
        )
    return out


class DistributedTiledGraph:
    """SGT-tiled graph partitioned over a ('graph', 'feature') mesh.

    Inputs/outputs of the ops are *globally shaped* jax.Arrays:
      * node features: ``[padded_nodes, D]``, sharded ``P('graph','feature')``
        (use :meth:`shard_features`);
      * per-edge vectors: ``[padded_edges]``, sharded ``P('graph')``.
    """

    def __init__(
        self,
        row_pointers: np.ndarray,
        column_index: np.ndarray,
        num_nodes: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        config: TileConfig = DEFAULT_CONFIG,
        d_tile: int = 8,
        dense_tiles: Optional[bool] = None,
        block_diag: Optional[bool] = None,
        split: Optional[bool] = None,
        streamed: Optional[bool] = None,
        _probe=None,
        _symmetric: Optional[bool] = None,
        _stream_limits: Optional[tuple] = None,
    ):
        if mesh is None:
            from tcgnn.parallel.mesh import make_mesh

            mesh = make_mesh()
        assert set(mesh.axis_names) == {"graph", "feature"}, mesh.axis_names
        row_pointers = np.asarray(row_pointers)
        column_index = np.asarray(column_index)
        if num_nodes is None:
            num_nodes = len(row_pointers) - 1
        self.mesh = mesh
        self.pg = int(mesh.shape["graph"])
        self.pf = int(mesh.shape["feature"])
        self.config = config
        self.num_nodes = int(num_nodes)
        self.num_edges = int(len(column_index))
        self.d_tile = d_tile

        blk_h = config.blk_h
        wd = _round_up(max(-(-self.num_nodes // blk_h), 1), self.pg) // self.pg
        rows_per_shard = wd * blk_h  # == partition_csr's derivation
        self.block_diag = False
        self._bd_host = None
        bdm = bdm_t = None
        t_csr = None  # probe's transpose triple — valid for THIS exact CSR
        if dense_tiles is not False and block_diag is not False:
            # ``_probe``: distributed_graph_from_dataset already ran the
            # (expensive) gate on this exact CSR — reuse it.
            self.block_diag, bdm, bdm_t, self.symmetric, t_csr = (
                _probe
                if _probe is not None
                else probe_block_diag(
                    row_pointers, column_index, self.num_nodes, self.pg, config
                )
            )
        else:
            self.symmetric = (
                _symmetric
                if _symmetric is not None
                else _is_symmetric(row_pointers, column_index, self.num_nodes)
            )
        if block_diag and not self.block_diag:
            raise ValueError(
                "block_diag requested but the graph is not fully covered "
                "by shard-compatible diagonals"
            )

        # Reddit-class shards exceed the one-shot chunk form's ceilings
        # exactly like the single-device path (sgt/stream.py); route to the
        # per-shard window-segment STREAMED composition: each shard
        # lax.scans one compiled chunk op over its segments inside the
        # shard map.
        self.streamed = False
        if streamed is None and not self.block_diag:
            streamed = _shards_need_streaming(
                row_pointers, column_index, self.num_nodes, self.pg, config
            )
        if streamed and not self.block_diag:
            self.streamed = True
            from tcgnn.sgt.translate import transpose_csr

            if t_csr is None:
                t_csr = transpose_csr(
                    row_pointers, column_index, self.num_nodes
                )
            return self._init_streamed(
                row_pointers, column_index, t_csr, mesh, config,
                _stream_limits,
            )

        # Mega-window block-stream split (partition.build_split): auto on
        # multi-shard non-BD graphs; build_split itself gates on measured
        # imbalance and returns None on balanced streams.
        want_split = (
            split is not False
            and dense_tiles is not False
            and not self.block_diag
            and self.pg > 1
            and config.block_group == 1
        )
        fwd, bwd = partition_graph(
            row_pointers, column_index, self.num_nodes, self.pg, config,
            build_tiles=not self.block_diag, split=want_split,
            transpose=t_csr,
        )
        assert fwd.rows_per_shard == rows_per_shard, (
            fwd.rows_per_shard, rows_per_shard,
        )
        self.host_fwd, self.host_bwd = fwd, bwd
        # Static per-offset halo exchange plans (partition.build_halo's
        # offset_caps), keyed by the send table's trace-time width: the
        # shard-mapped local fns serve BOTH directions from one closure and
        # see only the traced arrays, so the plan is recovered from the
        # send table's (static) shape.  Equal-width tables with different
        # plans are padded apart so the key stays unambiguous.
        self._halo_plans = {}
        for m in (fwd, bwd):
            if m is None or m.halo is None:
                continue
            plan = tuple(m.halo["rounds"])
            w = m.halo["send_idx"].shape[-1]
            while w in self._halo_plans and self._halo_plans[w] != plan:
                m.halo["send_idx"] = np.pad(
                    m.halo["send_idx"], ((0, 0), (0, 1))
                )
                w = m.halo["send_idx"].shape[-1]
            self._halo_plans[w] = plan
        self.padded_nodes = fwd.padded_nodes
        self.padded_edges = fwd.padded_edges
        self.edge_capacity = fwd.edge_capacity
        if self.block_diag:
            dense_tiles = True  # the BD packs ARE the dense-class format
        elif dense_tiles is None:
            # per-shard dense index space must fit int32
            dense_tiles = (
                max(fwd.a_tiles.shape[1], bwd.a_tiles.shape[1])
                * config.blk_h * config.blk_w < 2**31
            )
        self.dense_tiles = dense_tiles
        if not dense_tiles:
            # chunk fallback: the split stream is dense-kernel layout only
            fwd.split = bwd.split = None

        if self.block_diag:
            from tcgnn.parallel.blockdiag import build_bd_shard_meta

            self._bd_host = (
                build_bd_shard_meta(
                    bdm, fwd.edge_start, rows_per_shard,
                    self.pg, fwd.edge_capacity,
                ),
                build_bd_shard_meta(
                    bdm_t, bwd.edge_start, rows_per_shard,
                    self.pg, bwd.edge_capacity,
                ),
            )
            # The packed diagonals serve every op; the condensed window
            # tiling stays host-side (layout + stats only) and its device
            # arrays — the big HBM cost — are never built.
            self._fwd = self._bwd = None
        else:
            self._fwd = _meta_to_device(
                fwd, mesh, with_fwd_slot=False, dense=dense_tiles
            )
            self._bwd = _meta_to_device(
                bwd, mesh, with_fwd_slot=True, dense=dense_tiles
            )

        self._node_sh = NamedSharding(mesh, P("graph", "feature"))
        self._edge_sh = NamedSharding(mesh, P("graph"))
        self._ag_split = False  # set by _build_ops on fused-split graphs
        self._build_ops()

    # --- statistics (reference's preprocess printout, TCGNN.cpp:225) -------
    @property
    def tc_blocks(self) -> int:
        return self.host_fwd.num_real_blocks

    @property
    def exp_edges(self) -> int:
        return self.host_fwd.num_real_blocks * self.config.blk_h * self.config.blk_w

    # --- input placement ----------------------------------------------------
    def shard_features(self, x) -> jnp.ndarray:
        """Pad [N, D] node features to the mesh grid and place them sharded."""
        x = jnp.asarray(x)
        n, d = x.shape
        d_pad = _round_up(max(d, 1), self.d_tile * self.pf)
        x = jnp.pad(x, ((0, self.padded_nodes - n), (0, d_pad - d)))
        return jax.device_put(x, self._node_sh)

    def shard_nodes(self, v) -> jnp.ndarray:
        """Pad a per-node vector (labels, masks) to padded_nodes, sharded."""
        v = jnp.asarray(v)
        v = jnp.pad(v, [(0, self.padded_nodes - v.shape[0])] + [(0, 0)] * (v.ndim - 1))
        return jax.device_put(v, NamedSharding(self.mesh, P("graph")))

    def valid_node_mask(self) -> jnp.ndarray:
        mask = np.zeros(self.padded_nodes, dtype=np.float32)
        mask[: self.num_nodes] = 1.0
        return jax.device_put(jnp.asarray(mask), NamedSharding(self.mesh, P("graph")))

    def edge_weights_to_sharded(self, w_csr) -> jnp.ndarray:
        """Re-lay a [num_edges] CSR-ordered vector into the padded sharded
        edge layout [padded_edges]."""
        w_csr = np.asarray(w_csr)
        out = np.zeros((self.pg, self.edge_capacity), dtype=w_csr.dtype)
        es = self.host_fwd.edge_start
        for s in range(self.pg):
            lo, hi = int(es[s]), int(es[s + 1])
            out[s, : hi - lo] = w_csr[lo:hi]
        return jax.device_put(jnp.asarray(out.reshape(-1)), self._edge_sh)

    def gather_edge_vector(self, v) -> np.ndarray:
        """Sharded [padded_edges] -> host [num_edges] in CSR order."""
        v = np.asarray(v).reshape(self.pg, self.edge_capacity)
        es = self.host_fwd.edge_start
        parts = [v[s, : int(es[s + 1] - es[s])] for s in range(self.pg)]
        return np.concatenate(parts)

    # --- shard_map'ed primitives ---------------------------------------------
    def _shardmap(self, f, in_specs, out_specs):
        return jax.shard_map(
            f, mesh=self.mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )

    def _init_streamed(
        self, row_pointers, column_index, t_csr, mesh, config, stream_limits
    ):
        """Finish construction on the distributed STREAMED route.

        Light (layout-only) partition metas provide edge offsets /
        capacities / the transpose->forward slot table; the heavy
        per-shard data is the stacked window-segment metadata
        (``partition.partition_streamed``), scanned by one compiled chunk
        kernel per shard inside the shard map.  Halo = one all_gather of
        the sharded feature matrix (the chunk fallback's exchange): at
        Reddit scale the O(N*D) matrix is small next to the O(E) stream.
        """
        from tcgnn.parallel.partition import partition_streamed

        t_ptr, t_idx, t_src = t_csr
        fwd, bwd = partition_graph(
            row_pointers, column_index, self.num_nodes, self.pg, config,
            build_tiles=False, transpose=(t_ptr, t_idx, t_src),
        )
        self.host_fwd, self.host_bwd = fwd, bwd
        self._halo_plans = {}
        self.padded_nodes = fwd.padded_nodes
        self.padded_edges = fwd.padded_edges
        self.edge_capacity = fwd.edge_capacity
        self.dense_tiles = False
        self._bd_host = None
        self._fwd = self._bwd = None
        mc, msr = stream_limits if stream_limits is not None else (None, None)
        sp_f = partition_streamed(
            row_pointers, column_index, self.num_nodes, self.pg, config,
            edge_capacity=fwd.edge_capacity, max_chunks=mc,
            max_slab_rows=msr,
        )
        sp_b = partition_streamed(
            t_ptr, t_idx, self.num_nodes, self.pg, config,
            edge_capacity=bwd.edge_capacity, max_chunks=mc,
            max_slab_rows=msr,
        )
        sh = NamedSharding(mesh, P("graph"))

        def put(sp):
            return tuple(
                jax.device_put(jnp.asarray(sp["arrays"][k]), sh)
                for k in _STREAM_FIELDS
            )

        efs = jax.device_put(jnp.asarray(bwd.edge_fwd_slot), sh)
        self._device_arrays = (put(sp_f), put(sp_b) + (efs,))
        sp_f.pop("arrays")
        sp_b.pop("arrays")
        self._stream_static = (sp_f, sp_b)
        self._node_sh = NamedSharding(mesh, P("graph", "feature"))
        self._edge_sh = NamedSharding(mesh, P("graph"))
        self._ag_split = False
        self._build_ops()

    def _build_ops_streamed(self):
        """Shard-mapped streamed primitives (lax.scan over segments)."""
        from tcgnn.ops.sddmm import sddmm_tc_streamed
        from tcgnn.ops.spmm import spmm_tc_streamed
        from tcgnn.sgt.stream import StreamedJaxMeta

        cfg = self.config
        pf = self.pf
        sp_f, sp_b = self._stream_static
        rows = sp_f["rows_per_shard"]
        node_spec = P("graph", "feature")
        edge_spec = P("graph")
        specs = tuple(P("graph") for _ in _STREAM_FIELDS)

        def bind_smeta(m, sp):
            return StreamedJaxMeta(
                config=cfg,
                num_nodes=self.padded_nodes,
                num_edges=int(m["edge_perm"].shape[-1]),
                num_windows=sp["windows_per_shard"],
                wseg=sp["wseg"],
                num_segments=sp["num_segments"],
                **{
                    k: m[k][0]
                    for k in _STREAM_FIELDS
                    if k != "edge_valid"
                },
            )

        def _core(x_loc, w_loc, arrs, sp, weighted, fwd_slot):
            names = _STREAM_FIELDS + (("edge_fwd_slot",) if fwd_slot else ())
            m = dict(zip(names, arrs))
            smeta = bind_smeta(m, sp)
            x_full = jax.lax.all_gather(x_loc, "graph", axis=0, tiled=True)
            if weighted:
                if fwd_slot:
                    # Transpose weights arrive forward-ordered: all-gather
                    # the forward edge vector and route each local
                    # transpose edge through its fwd slot (sentinel -> the
                    # appended zero).
                    w_all = jax.lax.all_gather(
                        w_loc, "graph", axis=0, tiled=True
                    )
                    w_ext = jnp.concatenate(
                        [w_all, jnp.zeros((1,), w_all.dtype)]
                    )
                    w_dir = w_ext[m["edge_fwd_slot"][0]]
                else:
                    w_dir = w_loc
                out = spmm_tc_streamed(
                    x_full, smeta, edge_weights=w_dir
                )
            else:
                out = spmm_tc_streamed(x_full, smeta)
            return out[:rows]

        def local_u_f(x_loc, *arrs):
            return _core(x_loc, None, arrs, sp_f, False, False)

        def local_u_b(x_loc, *arrs):
            return _core(x_loc, None, arrs, sp_b, False, False)

        def local_w_f(x_loc, w_loc, *arrs):
            return _core(x_loc, w_loc, arrs, sp_f, True, False)

        def local_w_b(x_loc, w_loc, *arrs):
            return _core(x_loc, w_loc, arrs, sp_b, True, True)

        def local_sddmm(xa_loc, xb_loc, *arrs):
            m = dict(zip(_STREAM_FIELDS, arrs))
            smeta = bind_smeta(m, sp_f)
            xb_full = jax.lax.all_gather(xb_loc, "graph", axis=0, tiled=True)
            s = sddmm_tc_streamed(xa_loc, smeta, xb_full)
            s = jnp.where(m["edge_valid"][0], s, 0.0)
            if pf > 1:
                s = jax.lax.psum(s, "feature")
            return s

        self._stream_sms = (
            self._shardmap(local_u_f, in_specs=(node_spec,) + specs,
                           out_specs=node_spec),
            self._shardmap(local_u_b, in_specs=(node_spec,) + specs,
                           out_specs=node_spec),
            self._shardmap(local_w_f, in_specs=(node_spec, edge_spec) + specs,
                           out_specs=node_spec),
            self._shardmap(
                local_w_b,
                in_specs=(node_spec, edge_spec) + specs + (P("graph"),),
                out_specs=node_spec,
            ),
            self._shardmap(local_sddmm,
                           in_specs=(node_spec, node_spec) + specs,
                           out_specs=edge_spec),
        )
        ops = self._make_ops_streamed(*self._device_arrays)
        self.spmm, self.spmm_weighted, self.sddmm, self.agnn_aggregate = ops

    def _make_ops_streamed(self, fwd_meta, bwd_meta_slot):
        """Public custom_vjp ops over the streamed shard-mapped primitives
        (mirrors ``_make_ops`` minus split/overlap/fused-AGNN)."""
        bwd_meta = bwd_meta_slot[:-1]
        _u_f, _u_b, _w_f, _w_b, _sddmm = self._stream_sms
        d_quantum = 8 * self.pf

        def pad_d(x):
            d = x.shape[1]
            d_pad = _round_up(max(d, 1), d_quantum)
            if d_pad != d:
                x = jnp.pad(x, ((0, 0), (0, d_pad - d)))
            return x

        @jax.custom_vjp
        def spmm(x):
            return _u_f(pad_d(x), *fwd_meta)[:, : x.shape[1]]

        def spmm_fwd(x):
            return spmm(x), None

        def spmm_bwd(_, dy):
            return (_u_b(pad_d(dy), *bwd_meta)[:, : dy.shape[1]],)

        spmm.defvjp(spmm_fwd, spmm_bwd)

        @jax.custom_vjp
        def spmm_weighted(x, w):
            return _w_f(pad_d(x), w, *fwd_meta)[:, : x.shape[1]]

        def spmm_weighted_fwd(x, w):
            return spmm_weighted(x, w), (x, w)

        def spmm_weighted_bwd(res, dy):
            x, w = res
            dx = _w_b(pad_d(dy), w, *bwd_meta_slot)[:, : dy.shape[1]]
            dw = _sddmm(pad_d(dy), pad_d(x), *fwd_meta)
            return dx, dw

        spmm_weighted.defvjp(spmm_weighted_fwd, spmm_weighted_bwd)

        @jax.custom_vjp
        def sddmm(x):
            xp = pad_d(x)
            return _sddmm(xp, xp, *fwd_meta)

        def sddmm_fwd(x):
            return sddmm(x), x

        def sddmm_bwd(x, de):
            d_rows = spmm_weighted(x, de)
            d_cols = _w_b(pad_d(x), de, *bwd_meta_slot)[:, : x.shape[1]]
            return (d_rows + d_cols,)

        sddmm.defvjp(sddmm_fwd, sddmm_bwd)

        return spmm, spmm_weighted, sddmm, None

    def _build_ops(self):
        if self.streamed:
            return self._build_ops_streamed()
        if self.block_diag:
            return self._build_ops_bd()
        cfg = self.config
        wd = self.host_fwd.windows_per_shard
        pf = self.pf

        meta_specs = tuple(P("graph") for _ in _META_FIELDS)
        node_spec = P("graph", "feature")
        edge_spec = P("graph")

        def local_spmm(x_loc, w_loc, *meta, weighted, use_fwd_slot):
            m = dict(zip(_META_FIELDS + (("chunk_fwd_slot",) if use_fwd_slot else ()), meta))
            # Halo exchange: the whole sharded feature matrix moves once;
            # XLA overlaps this all-gather with independent work.
            x_full = jax.lax.all_gather(x_loc, "graph", axis=0, tiled=True)
            if weighted:
                if use_fwd_slot:
                    # Weights live in *forward* edge layout; gather them all
                    # and index through the transpose->forward slot table.
                    w_all = jax.lax.all_gather(w_loc, "graph", axis=0, tiled=True)
                    w_ext = jnp.concatenate([w_all, jnp.zeros((1,), w_all.dtype)])
                    chunk_w = w_ext[m["chunk_fwd_slot"][0]]
                else:
                    w_ext = jnp.concatenate([w_loc, jnp.zeros((1,), w_loc.dtype)])
                    chunk_w = w_ext[m["chunk_edge_id"][0]]
                chunk_w = chunk_w.astype(jnp.float32)
            else:
                chunk_w = jnp.zeros_like(m["chunk_r"][0])
            return _spmm_padded(
                x_full,
                m["col_ids"][0].reshape(-1),
                m["chunk_r"][0],
                m["chunk_c"][0],
                chunk_w,
                m["chunk_block"][0],
                m["chunk_window"][0],
                cfg=cfg,
                num_windows=wd,
                weighted=weighted,
            )

        def local_sddmm(xa_loc, xb_loc, *meta):
            m = dict(zip(_META_FIELDS, meta))
            xb_full = jax.lax.all_gather(xb_loc, "graph", axis=0, tiled=True)
            scores = _sddmm_padded(
                xa_loc,
                xb_full,
                m["col_ids"][0].reshape(-1),
                m["chunk_r"][0],
                m["chunk_c"][0],
                m["chunk_block"][0],
                m["chunk_window"][0],
                cfg=cfg,
            )
            s = scores.reshape(-1)[m["edge_perm"][0]]
            s = jnp.where(m["edge_valid"][0], s, 0.0)
            if pf > 1:
                s = jax.lax.psum(s, "feature")
            return s

        # ---- dense-tile local fns (default path) ---------------------------
        blk_h, blk_w = cfg.blk_h, cfg.blk_w
        pg = self.pg
        halo_plans = self._halo_plans

        def halo_exchange(x_loc, send_idx):
            """Boundary-only halo exchange over the graph axis.

            ``send_idx`` is this shard's ``[1, halo_rows]`` slice of the
            per-offset send table: for each owner offset o of the (static)
            exchange plan, a cap_o-wide segment of local rows destined for
            this shard's offset-o receiver (dest s receives from owner
            (s+o)%G — the segment order col_ids_ext's slots index).  The
            exchange runs the quantized partial-pair ROUNDS of
            ``partition.plan_halo_rounds``: each round is one ppermute of
            a size-``sz`` sub-segment listing only the pairs still owing
            rows, so light pairs stop after one round and only the heavy
            pair rides them all (the former single all_to_all padded
            every pair to the global max — 1.3-6.8x the ideal boundary
            bytes, round-4 comm_measured.csv).  Unlisted links move
            nothing; their receivers get ppermute's zero fill in slots no
            col_id references.  The result is the extended slab
            ``[rows_per_shard + halo_rows, d]``.  Replaces the full
            feature-matrix all_gather: per-device memory
            O(N/G + boundary), wire volume ~ the ideal boundary volume.
            """
            if pg == 1:
                return x_loc
            rounds = halo_plans[send_idx.shape[-1]]
            flat = send_idx[0]
            segs = [x_loc]
            for pos, sz, pairs in rounds:
                idx = jax.lax.slice_in_dim(flat, pos, pos + sz)
                send = jnp.take(x_loc, idx, axis=0, fill_value=0)
                segs.append(jax.lax.ppermute(send, "graph", pairs))
            return jnp.concatenate(segs, axis=0) if len(segs) > 1 else x_loc

        def _w_all_ext(w_loc):
            """All-gathered forward edge vector + appended zero — the shared
            sentinel target (index G*Emax gathers 0).  Per-edge scalars are
            O(E) total, small next to features."""
            w_all = jax.lax.all_gather(w_loc, "graph", axis=0, tiled=True)
            return jnp.concatenate([w_all, jnp.zeros((1,), w_all.dtype)])

        def _scatter_w_tiles(vals, edge_pos, n_blocks):
            """Per-edge f32 scalars -> weighted tiles; out-of-range positions
            (class/padding sentinels) drop."""
            return (
                jnp.zeros((n_blocks * blk_h * blk_w,), jnp.float32)
                .at[edge_pos].add(vals, mode="drop")
                .reshape(n_blocks, blk_h, blk_w)
            )

        def _make_guest_return(gcap, qcap):
            """The split stream's partial-tile return: guest output windows
            ride one all_to_all (send_pos lanes) and scatter-add into the
            owners' rows (recv_row_idx) — order-invariant float sums."""
            rows = wd * blk_h

            def guest_return(out, m, d):
                own = out[:rows, :d]
                guests = out[rows : rows + gcap * blk_h, :d].reshape(
                    gcap, blk_h, d
                )
                send = (
                    jnp.zeros((pg * qcap, blk_h, d), own.dtype)
                    .at[m["send_pos"][0]].set(guests, mode="drop")
                )
                recv = jax.lax.all_to_all(
                    send.reshape(pg, qcap * blk_h, d), "graph",
                    split_axis=0, concat_axis=0, tiled=True,
                )
                return own.at[m["recv_row_idx"][0]].add(
                    recv.reshape(pg * qcap * blk_h, d), mode="drop"
                )

            return guest_return

        def local_spmm_dense(x_loc, w_loc, *meta, weighted, use_fwd_slot):
            names = _DENSE_FIELDS + (("edge_fwd_slot",) if use_fwd_slot else ())
            m = dict(zip(names, meta))
            x_ext = halo_exchange(x_loc, m["send_idx"])
            if weighted:
                vals = _overlap_edge_vals(m, w_loc, use_fwd_slot)
                tiles = _scatter_w_tiles(
                    vals, m["edge_pos"][0], m["a_tiles"].shape[1]
                )
            else:
                tiles = m["a_tiles"][0]
            return _spmm_dense_padded(
                x_ext,
                tiles,
                m["col_ids_ext"][0],
                m["block_window"][0],
                cfg=cfg,
                num_windows=wd,
            )

        def local_sddmm_dense(xa_loc, xb_loc, *meta):
            m = dict(zip(_DENSE_FIELDS, meta))
            xb_ext = halo_exchange(xb_loc, m["send_idx"])
            tiles = _sddmm_dense_padded(
                xa_loc,
                xb_ext,
                m["col_ids_ext"][0],
                m["block_window"][0],
                cfg=cfg,
                num_windows=wd,
            )
            s = tiles.reshape(-1)[m["edge_pos"][0]]
            s = jnp.where(m["edge_valid"][0], s, 0.0)
            if pf > 1:
                s = jax.lax.psum(s, "feature")
            return s

        # ---- halo-overlap SpMM / weighted SpMM / SDDMM ---------------------
        # Blocks whose edges are all shard-resident run against the local
        # feature slab while the boundary exchange is in flight; XLA's async
        # collectives overlap the two.  (The reference has no multi-device
        # analogue; this is the mesh-level counterpart of overlapping
        # shared-memory loads with WMMA compute inside one GPU kernel.)
        # Weighted tiles
        # are built per class by scattering the per-edge scalars at the
        # class-relative ``edge_pos`` (other-class edges carry an
        # out-of-bounds sentinel that ``mode="drop"``/``mode="fill"``
        # silently ignores — see partition._stack_overlap).
        _OV_FIELDS = (
            ("send_idx", "edge_valid")
            + tuple("l_" + k for k in _OVERLAP_KEYS)
            + tuple("r_" + k for k in _OVERLAP_KEYS)
        )

        def _overlap_edge_vals(m, w_loc, use_fwd_slot):
            """Per-edge weight scalars in this shard's layout (f32)."""
            if use_fwd_slot:
                # Forward-ordered weights: gather all shards' slabs, then
                # index through the per-t-edge slot table.
                return _w_all_ext(w_loc)[m["edge_fwd_slot"][0]].astype(
                    jnp.float32
                )
            return jnp.where(m["edge_valid"][0], w_loc, 0.0).astype(jnp.float32)

        def local_spmm_overlap(x_loc, w_loc, *meta, weighted, use_fwd_slot):
            names = _OV_FIELDS + (("edge_fwd_slot",) if use_fwd_slot else ())
            m = dict(zip(names, meta))
            x_ext = halo_exchange(x_loc, m["send_idx"])
            vals = _overlap_edge_vals(m, w_loc, use_fwd_slot) if weighted else None

            def one(cls, x_src):
                a = m[cls + "a_tiles"][0]
                if weighted:
                    tiles = _scatter_w_tiles(
                        vals, m[cls + "edge_pos"][0], a.shape[0]
                    )
                else:
                    tiles = a
                return _spmm_dense_padded(
                    x_src, tiles, m[cls + "col_ids"][0],
                    m[cls + "block_window"][0],
                    cfg=cfg, num_windows=wd,
                )

            return one("l_", x_loc) + one("r_", x_ext)

        def local_sddmm_overlap(xa_loc, xb_loc, *meta):
            m = dict(zip(_OV_FIELDS, meta))
            xb_ext = halo_exchange(xb_loc, m["send_idx"])

            def one(cls, xb_src):
                tiles = _sddmm_dense_padded(
                    xa_loc, xb_src, m[cls + "col_ids"][0],
                    m[cls + "block_window"][0],
                    cfg=cfg, num_windows=wd,
                )
                return jnp.take(
                    tiles.reshape(-1), m[cls + "edge_pos"][0],
                    mode="fill", fill_value=0.0,
                )

            s = one("l_", xb_loc) + one("r_", xb_ext)
            s = jnp.where(m["edge_valid"][0], s, 0.0)
            if pf > 1:
                s = jax.lax.psum(s, "feature")
            return s

        # ---- fused tile-space AGNN (symmetric graphs; see TiledGraph) ------
        self._agnn_fwd_sm = self._agnn_bwd_sm = None
        self._ag_split = False
        spf = self.host_fwd.split
        if (
            self.dense_tiles and self.symmetric
            and spf is not None
        ):
            # Fused AGNN over the SPLIT stream.  Guest score tiles need the
            # OWNER's window rows on their xa side — exactly the rows
            # recv_row_idx describes — so they arrive by one dedicated
            # all_to_all (owners send x[recv_row_idx]; guests pick their
            # slots via xa_fetch).  This keeps the shared halo capacity
            # untouched: GCN/GIN pay nothing for AGNN's extra rows.  s/t
            # tiles, the fused weighted sums, and the column-space gradient
            # all run on the balanced stream; guest output tiles return
            # through the same partial-tile all_to_all as the SpMMs.
            self._ag_split = True
            ag_gcap, ag_qcap = int(spf["guest_cap"]), int(spf["pair_cap"])
            ag_rows = wd * blk_h
            ag_nw = wd + ag_gcap
            ag_guest_return = _make_guest_return(ag_gcap, ag_qcap)

            def xa_guest_rows(a_loc, m):
                """Owner-window rows for this shard's guest slots."""
                send = jnp.take(
                    a_loc, m["recv_row_idx"][0], axis=0, fill_value=0
                )
                recv = jax.lax.all_to_all(
                    send.reshape(pg, ag_qcap * blk_h, a_loc.shape[1]),
                    "graph", split_axis=0, concat_axis=0, tiled=True,
                )
                return jnp.take(
                    recv.reshape(pg * ag_qcap * blk_h, a_loc.shape[1]),
                    m["xa_fetch"][0], axis=0, fill_value=0,
                )

            def s_tiles_split(xa_str, x_ext, m):
                s = _sddmm_dense_padded(
                    xa_str, x_ext, m["col_ids_ext"][0],
                    m["block_window"][0], cfg=cfg, num_windows=ag_nw,
                    out_dtype=cfg.compute_dtype,
                )
                if pf > 1:
                    s = jax.lax.psum(
                        s.astype(jnp.float32), "feature"
                    ).astype(s.dtype)
                return s

            def fused_split(x_src, s, m):
                return _spmm_fused_padded(
                    x_src, m["a_tiles"][0], s, m["col_ids_ext"][0],
                    m["block_window"][0],
                    cfg=cfg, num_windows=ag_nw,
                )

            def sfused_split(xl, xr, xv, m):
                """Score-fused pass over the split stream (pf==1 only —
                in-kernel scores contract the full feature dim)."""
                return _spmm_sfused_padded(
                    xl, xr, xv, m["a_tiles"][0], m["col_ids_ext"][0],
                    m["block_window"][0],
                    cfg=cfg, num_windows=ag_nw,
                )

            def local_agnn_fwd(x_loc, *meta):
                m = dict(zip(_SPLIT_FIELDS, meta))
                x_ext = halo_exchange(x_loc, m["send_idx"])
                x_str = jnp.concatenate([x_loc, xa_guest_rows(x_loc, m)])
                if pf == 1:
                    y = sfused_split(x_str, x_ext, None, m)
                else:
                    s = s_tiles_split(x_str, x_ext, m)
                    y = fused_split(x_ext, s, m)
                return ag_guest_return(y, m, x_loc.shape[1])

            def local_agnn_bwd(x_loc, dy_loc, *meta):
                m = dict(zip(_SPLIT_FIELDS, meta))
                d = x_loc.shape[1]
                x_ext = halo_exchange(x_loc, m["send_idx"])
                dy_ext = halo_exchange(dy_loc, m["send_idx"])
                x_str = jnp.concatenate([x_loc, xa_guest_rows(x_loc, m)])
                dy_g = xa_guest_rows(dy_loc, m)
                # Global symmetry turns the column-space gradient term into
                # a ROW-space pass: (A⊙T)ᵀx = (A⊙Tᵀ)x with
                # Tᵀ_ij = <x_i, dy_j> — score tiles of x against the dy
                # halo slab (already exchanged for t1).  All three dx terms
                # sum BEFORE one guest exchange (float add is
                # order-invariant); no column-space kernel, no scatter, no
                # reverse halo exchange.
                if pf == 1:
                    # Score-fused one-pass backward: u rides along with the
                    # three dx terms.
                    # Window sources are the split layout (own + guest
                    # rows); gathers read the extended halo slabs.
                    y123, u = _spmm_sfused_bwd_padded(
                        x_ext, dy_ext, m["a_tiles"][0],
                        m["col_ids_ext"][0], m["block_window"][0],
                        cfg=cfg, num_windows=ag_nw,
                        xw=x_str, dyw=jnp.concatenate([dy_loc, dy_g]),
                    )
                else:
                    s = s_tiles_split(x_str, x_ext, m)   # S_ij = <x_i, x_j>
                    t = s_tiles_split(
                        jnp.concatenate([dy_loc, dy_g]), x_ext, m
                    )                                    # T_ij = <dy_i, x_j>
                    u_t = s_tiles_split(x_str, dy_ext, m)
                    y123 = (
                        fused_split(dy_ext, s, m)
                        + fused_split(x_ext, t, m)
                        + fused_split(x_ext, u_t, m)
                    )
                    u = fused_split(x_ext, s, m)
                dx = ag_guest_return(y123, m, d)
                # dc = <dy, (A*S)x>: every partial output tile is attributed
                # exactly once — own head blocks against dy_loc, guest tiles
                # against the owner's dy rows (already fetched as dy_g).
                dc = jnp.vdot(
                    dy_loc.astype(jnp.float32), u[:ag_rows, :d]
                ) + jnp.vdot(
                    dy_g.astype(jnp.float32),
                    u[ag_rows : ag_rows + ag_gcap * blk_h, :d],
                )
                dc = jax.lax.psum(dc, "graph")
                if pf > 1:
                    dc = jax.lax.psum(dc, "feature")
                return dx, dc

            ag_specs = tuple(P("graph") for _ in _SPLIT_FIELDS)
            self._agnn_fwd_sm = self._shardmap(
                local_agnn_fwd,
                in_specs=(node_spec,) + ag_specs,
                out_specs=node_spec,
            )
            self._agnn_bwd_sm = self._shardmap(
                local_agnn_bwd,
                in_specs=(node_spec, node_spec) + ag_specs,
                out_specs=(node_spec, P()),
            )
        elif self.dense_tiles and self.symmetric:
            AG_FIELDS = (
                "a_tiles", "col_ids_ext", "block_window",
                "block_first_in_window", "send_idx",
            )
            ag_specs = tuple(P("graph") for _ in AG_FIELDS)
            self._ag_fields = AG_FIELDS

            def s_tiles_loc(xa_loc, x_ext, m):
                s = _sddmm_dense_padded(
                    xa_loc, x_ext, m["col_ids_ext"][0], m["block_window"][0],
                    cfg=cfg, num_windows=wd, out_dtype=cfg.compute_dtype,
                )
                if pf > 1:  # scores contract over the full feature dim
                    s = jax.lax.psum(s.astype(jnp.float32), "feature").astype(s.dtype)
                return s

            def fused_loc(x_ext, s, m):
                return _spmm_fused_padded(
                    x_ext, m["a_tiles"][0], s, m["col_ids_ext"][0],
                    m["block_window"][0],
                    cfg=cfg, num_windows=wd,
                )

            if pf == 1:
                # Score-fused distributed AGNN (parity with the
                # single-device path): the fused backward returns all three
                # dx terms + u in one call.  The extended slab's local rows
                # come first, so x_ext doubles as the window source (the
                # padded ops trim it to wd windows).  pf>1 keeps the
                # materializing path: fused scores would be partial
                # over the feature shard and need the explicit psum.
                def local_agnn_fwd(x_loc, *meta):
                    m = dict(zip(AG_FIELDS, meta))
                    x_ext = halo_exchange(x_loc, m["send_idx"])
                    out = _spmm_sfused_padded(
                        x_ext, x_ext, None, m["a_tiles"][0],
                        m["col_ids_ext"][0], m["block_window"][0],
                        cfg=cfg, num_windows=wd,
                    )
                    return out[:, : x_loc.shape[1]]

                def local_agnn_bwd(x_loc, dy_loc, *meta):
                    m = dict(zip(AG_FIELDS, meta))
                    d = x_loc.shape[1]
                    x_ext = halo_exchange(x_loc, m["send_idx"])
                    dy_ext = halo_exchange(dy_loc, m["send_idx"])
                    dx3, u = _spmm_sfused_bwd_padded(
                        x_ext, dy_ext, m["a_tiles"][0],
                        m["col_ids_ext"][0], m["block_window"][0],
                        cfg=cfg, num_windows=wd,
                    )
                    dc = jnp.vdot(
                        dy_loc.astype(jnp.float32),
                        u[: x_loc.shape[0], :d],
                    )
                    dc = jax.lax.psum(dc, "graph")
                    return dx3[:, :d], dc

            else:

                def local_agnn_fwd(x_loc, *meta):
                    m = dict(zip(AG_FIELDS, meta))
                    x_ext = halo_exchange(x_loc, m["send_idx"])
                    s = s_tiles_loc(x_loc, x_ext, m)
                    return fused_loc(x_ext, s, m)[:, : x_loc.shape[1]]

                def local_agnn_bwd(x_loc, dy_loc, *meta):
                    m = dict(zip(AG_FIELDS, meta))
                    d = x_loc.shape[1]
                    x_ext = halo_exchange(x_loc, m["send_idx"])
                    dy_ext = halo_exchange(dy_loc, m["send_idx"])
                    s = s_tiles_loc(x_loc, x_ext, m)   # S_ij = <x_i, x_j>
                    t = s_tiles_loc(dy_loc, x_ext, m)  # T_ij = <dy_i, x_j>
                    t1 = fused_loc(dy_ext, s, m)[:, :d]
                    t2a = fused_loc(x_ext, t, m)[:, :d]
                    # Column-space term via global symmetry, in ROW space:
                    # (A⊙T)ᵀx = (A⊙Tᵀ)x with Tᵀ_ij = <x_i, dy_j> — score
                    # tiles of x against the dy halo slab (already
                    # exchanged for t1).  No column-space kernel, scatter,
                    # or reverse exchange.
                    u_t = s_tiles_loc(x_loc, dy_ext, m)
                    t2b = fused_loc(x_ext, u_t, m)[:, :d]
                    u = fused_loc(x_ext, s, m)[:, :d]
                    dc = jnp.vdot(dy_loc.astype(jnp.float32), u)
                    dc = jax.lax.psum(dc, "graph")
                    dc = jax.lax.psum(dc, "feature")
                    return t1 + t2a + t2b, dc

            self._agnn_fwd_sm = self._shardmap(
                local_agnn_fwd,
                in_specs=(node_spec,) + ag_specs,
                out_specs=node_spec,
            )
            self._agnn_bwd_sm = self._shardmap(
                local_agnn_bwd,
                in_specs=(node_spec, node_spec) + ag_specs,
                out_specs=(node_spec, P()),
            )

        if self.dense_tiles:
            fields, spmm_fn, sddmm_fn = _DENSE_FIELDS, local_spmm_dense, local_sddmm_dense
        else:
            fields, spmm_fn, sddmm_fn = _META_FIELDS, local_spmm, local_sddmm
        field_specs = tuple(P("graph") for _ in fields)

        use_overlap = (
            self.dense_tiles
            and "overlap" in self._fwd
            and "overlap" in self._bwd
        )
        self._use_overlap = use_overlap
        if use_overlap:
            ov_specs = tuple(P("graph") for _ in _OV_FIELDS)
            _spmm_u = self._shardmap(
                functools.partial(
                    local_spmm_overlap, weighted=False, use_fwd_slot=False
                ),
                in_specs=(node_spec, edge_spec) + ov_specs,
                out_specs=node_spec,
            )
            _spmm_w = self._shardmap(
                functools.partial(
                    local_spmm_overlap, weighted=True, use_fwd_slot=False
                ),
                in_specs=(node_spec, edge_spec) + ov_specs,
                out_specs=node_spec,
            )
            _spmm_w_t = self._shardmap(
                functools.partial(
                    local_spmm_overlap, weighted=True, use_fwd_slot=True
                ),
                in_specs=(node_spec, edge_spec) + ov_specs + (P("graph"),),
                out_specs=node_spec,
            )
            _sddmm = self._shardmap(
                local_sddmm_overlap,
                in_specs=(node_spec, node_spec) + ov_specs,
                out_specs=edge_spec,
            )
        else:
            _spmm_u = self._shardmap(
                functools.partial(spmm_fn, weighted=False, use_fwd_slot=False),
                in_specs=(node_spec, edge_spec) + field_specs,
                out_specs=node_spec,
            )
            _spmm_w = self._shardmap(
                functools.partial(spmm_fn, weighted=True, use_fwd_slot=False),
                in_specs=(node_spec, edge_spec) + field_specs,
                out_specs=node_spec,
            )
            _spmm_w_t = self._shardmap(
                functools.partial(spmm_fn, weighted=True, use_fwd_slot=True),
                in_specs=(node_spec, edge_spec) + field_specs + (P("graph"),),
                out_specs=node_spec,
            )
            _sddmm = self._shardmap(
                sddmm_fn,
                in_specs=(node_spec, node_spec) + field_specs,
                out_specs=edge_spec,
            )

        self._spmm_u, self._spmm_w, self._spmm_w_t, self._sddmm_raw = (
            _spmm_u, _spmm_w, _spmm_w_t, _sddmm,
        )

        # ---- mega-window block-stream split (dense SpMM, both flavours) ---
        # Guest windows are extra output slots past the shard's own rows;
        # one all_to_all of partial [blk_h, d] tiles returns them to their
        # owners, which scatter-add (order-invariant float sum).  The
        # weighted flavour rebuilds the split stream's tiles on device:
        # guest blocks need the owner's per-edge scalars, so ONE all_gather
        # of the forward-ordered edge vector (O(E) scalars — the transpose
        # path pays it anyway for fwd-ordered weights) makes every weight
        # visible, then w_all[w_src] scattered at the split-stream edge_pos
        # yields this shard's tiles.  Per-edge outputs (SDDMM) keep the
        # unsplit stream; see partition.build_split.
        def _make_split_fn(meta_host, weighted=False):
            sp = meta_host.split
            if sp is None or not self.dense_tiles:
                return None
            gcap, qcap = int(sp["guest_cap"]), int(sp["pair_cap"])
            guest_return = _make_guest_return(gcap, qcap)

            def local_spmm_split(x_loc, *args):
                if weighted:
                    w_loc, *meta = args
                else:
                    meta = args
                m = dict(zip(_SPLIT_FIELDS, meta))
                x_ext = halo_exchange(x_loc, m["send_idx"])
                if weighted:
                    vals = _w_all_ext(w_loc)[m["w_src"][0]].astype(jnp.float32)
                    tiles = _scatter_w_tiles(
                        vals, m["edge_pos"][0], m["a_tiles"].shape[1]
                    )
                else:
                    tiles = m["a_tiles"][0]
                out = _spmm_dense_padded(
                    x_ext, tiles, m["col_ids_ext"][0],
                    m["block_window"][0],
                    cfg=cfg, num_windows=wd + gcap,
                )
                return guest_return(out, m, out.shape[1])

            sp_specs = tuple(P("graph") for _ in _SPLIT_FIELDS)
            in_specs = (
                (node_spec, edge_spec) + sp_specs
                if weighted
                else (node_spec,) + sp_specs
            )
            return self._shardmap(
                local_spmm_split, in_specs=in_specs, out_specs=node_spec
            )

        self._spmm_split_f = _make_split_fn(self.host_fwd)
        self._spmm_split_b = _make_split_fn(self.host_bwd)
        self._spmm_w_split_f = _make_split_fn(self.host_fwd, weighted=True)
        self._spmm_w_split_b = _make_split_fn(self.host_bwd, weighted=True)
        zero_w = jax.device_put(
            jnp.zeros(self.padded_edges, jnp.float32), self._edge_sh
        )
        slot_key = "edge_fwd_slot" if self.dense_tiles else "chunk_fwd_slot"
        self._device_arrays = (
            tuple(self._fwd[k] for k in fields),
            tuple(self._bwd[k] for k in fields) + (self._bwd[slot_key],),
            zero_w,
            (self._fwd["send_idx"], self._fwd["edge_valid"])
            + self._fwd["overlap"]
            if use_overlap
            else None,
            (self._bwd["send_idx"], self._bwd["edge_valid"])
            + self._bwd["overlap"]
            + (self._bwd[slot_key],)
            if use_overlap
            else None,
            (
                self._fwd["split"] + (self._fwd["send_idx"],)
                if self._ag_split
                else tuple(self._fwd[k] for k in self._ag_fields)
            )
            if self._agnn_fwd_sm is not None
            else None,
            self._fwd["split"] + (self._fwd["send_idx"],)
            if self._spmm_split_f is not None
            else None,
            self._bwd["split"] + (self._bwd["send_idx"],)
            if self._spmm_split_b is not None
            else None,
        )
        ops = self._make_ops(*self._device_arrays)
        self.spmm, self.spmm_weighted, self.sddmm, self.agnn_aggregate = ops

    def _build_ops_bd(self):
        """Sharded packed-diagonal ops: bin-aligned shards, ppermute rim halo.

        See ``parallel/blockdiag.py`` for the design.  Each op is ONE
        batched contraction per shard against a rim-extended feature
        stack; the rim is two nearest-neighbor ``ppermute`` shifts of
        ``max|k|*128`` rows (mesh-edge shards receive ppermute's zero fill
        — exactly the single-device op's zero padding).
        """
        cfg = self.config
        ct = cfg.compute_dtype
        pg, pf = self.pg, self.pf
        node_spec = P("graph", "feature")
        edge_spec = P("graph")
        sh_g = NamedSharding(self.mesh, P("graph"))
        mf, mt = self._bd_host

        def put(a):
            return jax.device_put(jnp.asarray(a), sh_g)

        idx_f, cnt_f, cov_f = put(mf.pack_idx), put(mf.pack_cnt), put(mf.cov_slot)
        idx_t, cnt_t, cov_t = put(mt.pack_idx), put(mt.pack_cnt), put(mt.cov_slot)
        efs = put(self.host_bwd.edge_fwd_slot)

        def mk_pack_builder(m):
            k, b_loc, bn = len(m.offsets), m.bins_per_shard, m.bin_rows

            def build(idx, cnt):
                flat = jnp.zeros((k * b_loc * bn * bn,), cnt.dtype)
                flat = flat.at[idx[0]].add(cnt[0], mode="drop")
                return (
                    flat.reshape(k, b_loc, bn, bn)
                    .transpose(1, 2, 0, 3)
                    .reshape(b_loc, bn, k * bn)
                )

            return jax.jit(self._shardmap(
                build, in_specs=(P("graph"), P("graph")), out_specs=P("graph")
            ))

        pack_f = mk_pack_builder(mf)(idx_f, cnt_f)
        pack_t = pack_f if self.symmetric else mk_pack_builder(mt)(idx_t, cnt_t)

        def rim_stack(x_loc, offs, b_loc, bn):
            """[b_loc, K*bn, d] halo stack from the local slab + rim shifts."""
            d = x_loc.shape[1]
            # 0-inclusive like ops.spmm._bd_stack: one-signed offset sets
            # must not produce negative pad/slice arithmetic.
            kmin, kmax = min(0, min(offs)), max(0, max(offs))
            xb = x_loc.astype(ct)
            parts = []
            if kmin < 0:
                src = xb[-(-kmin * bn):]
                parts.append(
                    jax.lax.ppermute(
                        src, "graph", [(i, i + 1) for i in range(pg - 1)]
                    )
                    if pg > 1
                    else jnp.zeros_like(src)
                )
            parts.append(xb)
            if kmax > 0:
                src = xb[: kmax * bn]
                parts.append(
                    jax.lax.ppermute(
                        src, "graph", [(i, i - 1) for i in range(1, pg)]
                    )
                    if pg > 1
                    else jnp.zeros_like(src)
                )
            xe = jnp.concatenate(parts, 0).reshape(
                b_loc + (kmax - kmin), bn, d
            )
            return jnp.stack(
                [xe[k - kmin : k - kmin + b_loc] for k in offs], axis=1
            ).reshape(b_loc, len(offs) * bn, d)

        def _contract(pack_loc, xs, b_loc, bn, d):
            out = jnp.einsum(
                "bik,bkd->bid",
                pack_loc.astype(ct),
                xs,
                preferred_element_type=jnp.float32,
                precision=_precision(ct),
            )
            return out.reshape(b_loc * bn, d)

        def mk_spmm(m):
            offs, bn, b_loc = m.offsets, m.bin_rows, m.bins_per_shard

            def local_fn(x_loc, pack_loc):
                xs = rim_stack(x_loc, offs, b_loc, bn)
                return _contract(pack_loc, xs, b_loc, bn, x_loc.shape[1])

            return self._shardmap(
                local_fn, in_specs=(node_spec, P("graph")), out_specs=node_spec
            )

        def mk_spmm_w(m, use_fwd_slot):
            offs, bn, b_loc = m.offsets, m.bin_rows, m.bins_per_shard
            size = b_loc * bn * len(offs) * bn

            def local_fn(x_loc, w_loc, cov_loc, *efs_loc):
                if use_fwd_slot:
                    w_all = jax.lax.all_gather(
                        w_loc, "graph", axis=0, tiled=True
                    )
                    w_ext = jnp.concatenate(
                        [w_all, jnp.zeros((1,), w_all.dtype)]
                    )
                    vals = w_ext[efs_loc[0][0]]
                else:
                    vals = w_loc
                pack = (
                    jnp.zeros((size,), ct)
                    .at[cov_loc[0]]
                    .add(vals.astype(ct), mode="drop")
                    .reshape(b_loc, bn, len(offs) * bn)
                )
                xs = rim_stack(x_loc, offs, b_loc, bn)
                return _contract(pack, xs, b_loc, bn, x_loc.shape[1])

            extra = (P("graph"),) if use_fwd_slot else ()
            return self._shardmap(
                local_fn,
                in_specs=(node_spec, edge_spec, P("graph")) + extra,
                out_specs=node_spec,
            )

        def mk_sddmm(m):
            offs, bn, b_loc = m.offsets, m.bin_rows, m.bins_per_shard

            def local_fn(xa_loc, xb_loc, cov_loc):
                xs = rim_stack(xb_loc, offs, b_loc, bn)
                xab = xa_loc.astype(ct).reshape(b_loc, bn, xa_loc.shape[1])
                s = jnp.einsum(
                    "bid,bkd->bik",
                    xab,
                    xs,
                    preferred_element_type=jnp.float32,
                    precision=_precision(ct),
                )
                e = jnp.take(
                    s.reshape(-1), cov_loc[0], mode="fill", fill_value=0.0
                )
                if pf > 1:
                    e = jax.lax.psum(e, "feature")
                return e

            return self._shardmap(
                local_fn,
                in_specs=(node_spec, node_spec, P("graph")),
                out_specs=edge_spec,
            )

        self._bd_spmm_f = mk_spmm(mf)
        self._bd_spmm_t = mk_spmm(mt)
        self._bd_spmm_w_f = mk_spmm_w(mf, use_fwd_slot=False)
        self._bd_spmm_w_t = mk_spmm_w(mt, use_fwd_slot=True)
        self._bd_sddmm = mk_sddmm(mf)

        # ---- fused tile-space AGNN (symmetric graphs; BD-mode analogue of
        # local_agnn_* in _build_ops): scores, weighted pack, and the
        # aggregate all stay in the shard's packed layout — no per-edge
        # scatter/gather round trip.  The backward's column-space term
        # spills rim bins to the neighbors via two reverse ppermute adds.
        self._bd_agnn_fwd = self._bd_agnn_bwd = None
        if self.symmetric:
            offs, bn, b_loc = mf.offsets, mf.bin_rows, mf.bins_per_shard
            kmin, kmax = min(0, min(offs)), max(0, max(offs))

            def s_tiles(xa_loc, xs):
                xab = xa_loc.astype(ct).reshape(b_loc, bn, xa_loc.shape[1])
                s = jnp.einsum(
                    "bid,bkd->bik",
                    xab,
                    xs,
                    preferred_element_type=jnp.float32,
                    precision=_precision(ct),
                )
                if pf > 1:  # scores contract over the full feature dim
                    s = jax.lax.psum(s, "feature")
                return s.astype(ct)

            def agnn_fwd_loc(x_loc, pack_loc):
                xs = rim_stack(x_loc, offs, b_loc, bn)
                wt = pack_loc.astype(ct) * s_tiles(x_loc, xs)
                return _contract(wt, xs, b_loc, bn, x_loc.shape[1])

            def transpose_core_loc(t, x_loc):
                """``out[b+k] += t_k[b]^T x_bins[b]`` with rim spill-back."""
                d = x_loc.shape[1]
                xab = x_loc.astype(ct).reshape(b_loc, bn, d)
                z = jnp.einsum(
                    "bik,bid->bkd",
                    t,
                    xab,
                    preferred_element_type=jnp.float32,
                    precision=_precision(ct),
                )
                out = jnp.zeros((b_loc + kmax - kmin, bn, d), jnp.float32)
                for i, k in enumerate(offs):
                    out = out.at[k - kmin : k - kmin + b_loc].add(
                        z[:, i * bn : (i + 1) * bn, :]
                    )
                res = out[-kmin : -kmin + b_loc]
                if kmin < 0:
                    spill = out[:-kmin].reshape(-kmin * bn, d)
                    recv = (
                        jax.lax.ppermute(
                            spill, "graph", [(i, i - 1) for i in range(1, pg)]
                        )
                        if pg > 1
                        else jnp.zeros_like(spill)
                    )
                    res = res.at[b_loc + kmin :].add(
                        recv.reshape(-kmin, bn, d)
                    )
                if kmax > 0:
                    spill = out[b_loc - kmin :].reshape(kmax * bn, d)
                    recv = (
                        jax.lax.ppermute(
                            spill, "graph", [(i, i + 1) for i in range(pg - 1)]
                        )
                        if pg > 1
                        else jnp.zeros_like(spill)
                    )
                    res = res.at[:kmax].add(recv.reshape(kmax, bn, d))
                return res.reshape(b_loc * bn, d)

            def agnn_bwd_loc(x_loc, dy_loc, pack_loc):
                d = x_loc.shape[1]
                c = pack_loc.astype(ct)
                xs = rim_stack(x_loc, offs, b_loc, bn)
                dys = rim_stack(dy_loc, offs, b_loc, bn)
                cs = c * s_tiles(x_loc, xs)     # C ⊙ S,  S_ij = <x_i, x_j>
                t = c * s_tiles(dy_loc, xs)     # C ⊙ T,  T_ij = <dy_i, x_j>
                t1 = _contract(cs, dys, b_loc, bn, d)
                t2a = _contract(t, xs, b_loc, bn, d)
                t2b = transpose_core_loc(t, x_loc)
                u = _contract(cs, xs, b_loc, bn, d)
                dc = jnp.vdot(dy_loc.astype(jnp.float32), u)
                dc = jax.lax.psum(dc, "graph")
                if pf > 1:
                    dc = jax.lax.psum(dc, "feature")
                return t1 + t2a + t2b, dc

            self._bd_agnn_fwd = self._shardmap(
                agnn_fwd_loc,
                in_specs=(node_spec, P("graph")),
                out_specs=node_spec,
            )
            self._bd_agnn_bwd = self._shardmap(
                agnn_bwd_loc,
                in_specs=(node_spec, node_spec, P("graph")),
                out_specs=(node_spec, P()),
            )

        self._device_arrays = (pack_f, pack_t, cov_f, cov_t, efs)
        ops = self._make_ops_bd(*self._device_arrays)
        self.spmm, self.spmm_weighted, self.sddmm, self.agnn_aggregate = ops

    def _make_ops_bd(self, pack_f, pack_t, cov_f, cov_t, efs):
        d_quantum = 8 * self.pf

        def pad_d(x):
            d = x.shape[1]
            d_pad = _round_up(max(d, 1), d_quantum)
            if d_pad != d:
                x = jnp.pad(x, ((0, 0), (0, d_pad - d)))
            return x

        _sp_f, _sp_t = self._bd_spmm_f, self._bd_spmm_t
        _sw_f, _sw_t, _sd = self._bd_spmm_w_f, self._bd_spmm_w_t, self._bd_sddmm

        @jax.custom_vjp
        def spmm(x):
            return _sp_f(pad_d(x), pack_f)[:, : x.shape[1]]

        def spmm_fwd(x):
            return spmm(x), None

        def spmm_bwd(_, dy):
            return (_sp_t(pad_d(dy), pack_t)[:, : dy.shape[1]],)

        spmm.defvjp(spmm_fwd, spmm_bwd)

        @jax.custom_vjp
        def spmm_weighted(x, w):
            return _sw_f(pad_d(x), w, cov_f)[:, : x.shape[1]]

        def spmm_weighted_fwd(x, w):
            return spmm_weighted(x, w), (x, w)

        def spmm_weighted_bwd(res, dy):
            x, w = res
            dx = _sw_t(pad_d(dy), w, cov_t, efs)[:, : x.shape[1]]
            dw = _sd(pad_d(dy), pad_d(x), cov_f)
            return dx, dw

        spmm_weighted.defvjp(spmm_weighted_fwd, spmm_weighted_bwd)

        @jax.custom_vjp
        def sddmm(x):
            xp = pad_d(x)
            return _sd(xp, xp, cov_f)

        def sddmm_fwd(x):
            return sddmm(x), x

        def sddmm_bwd(x, de):
            xp = pad_d(x)
            d_rows = _sw_f(xp, de, cov_f)[:, : x.shape[1]]
            d_cols = _sw_t(xp, de, cov_t, efs)[:, : x.shape[1]]
            return (d_rows + d_cols,)

        sddmm.defvjp(sddmm_fwd, sddmm_bwd)

        # ---- fused AGNN aggregation (symmetric; see _build_ops_bd) ---------
        agnn_aggregate = None
        if self._bd_agnn_fwd is not None:
            _agf, _agb = self._bd_agnn_fwd, self._bd_agnn_bwd

            @jax.custom_vjp
            def agnn_aggregate(x, att_w):
                cbar = jnp.mean(att_w)
                return cbar * _agf(pad_d(x), pack_f)[:, : x.shape[1]]

            def ag_fwd(x, att_w):
                return agnn_aggregate(x, att_w), (x, att_w)

            def ag_bwd(res, dy):
                x, att_w = res
                cbar = jnp.mean(att_w)
                dxl, dc = _agb(pad_d(x), pad_d(dy), pack_f)
                dx = cbar * dxl[:, : x.shape[1]]
                datt = jnp.full(att_w.shape, dc / att_w.size, att_w.dtype)
                return dx, datt

            agnn_aggregate.defvjp(ag_fwd, ag_bwd)

        return spmm, spmm_weighted, sddmm, agnn_aggregate

    # --- jit-boundary plumbing ---------------------------------------------
    def arrays(self):
        """Device-array pytree to pass INTO a jitted step (then ``bind``) —
        avoids embedding the sharded metadata as HLO constants."""
        return self._device_arrays

    def bind(self, device_arrays) -> "BoundDistributedGraph":
        if self.streamed:
            mk = self._make_ops_streamed
        elif self.block_diag:
            mk = self._make_ops_bd
        else:
            mk = self._make_ops
        return BoundDistributedGraph(self, mk(*device_arrays))

    def _make_ops(
        self, fwd_meta, bwd_meta_slot, zero_w, ov_fwd=None, ov_bwd=None,
        ag_meta=None, sp_fwd=None, sp_bwd=None,
    ):
        bwd_meta = bwd_meta_slot[:-1]
        if self._use_overlap:
            # Every dense op rides the local/remote split: unweighted,
            # weighted (both directions), and SDDMM overlap local-class
            # compute with the boundary exchange.  ``ov_bwd`` carries the
            # transpose partition's edge_fwd_slot as its last element.
            u_fwd_args = w_fwd_args = sddmm_args = ov_fwd
            u_bwd_args = ov_bwd[:-1]
            w_bwd_args = ov_bwd
        else:
            u_fwd_args = w_fwd_args = sddmm_args = fwd_meta
            u_bwd_args = bwd_meta
            w_bwd_args = bwd_meta_slot
        _spmm_u, _spmm_w, _spmm_w_t, _sddmm = (
            self._spmm_u, self._spmm_w, self._spmm_w_t, self._sddmm_raw,
        )
        # Narrow feature dims stay narrow (the dense kernels accept any
        # 8-aligned local width); only shard divisibility is required.
        d_quantum = 8 * self.pf

        def pad_d(x):
            """Pad the feature dim so each feature shard gets an 8-aligned
            slice (the kernels handle sub-128 widths natively)."""
            d = x.shape[1]
            d_pad = _round_up(max(d, 1), d_quantum)
            if d_pad != d:
                x = jnp.pad(x, ((0, 0), (0, d_pad - d)))
            return x

        # Mega-window block-stream split: overrides the dense SpMM (both
        # flavours) per direction when the partition built one (_build_ops).
        _spmm_sf = self._spmm_split_f if sp_fwd is not None else None
        _spmm_sb = self._spmm_split_b if sp_bwd is not None else None
        _spmm_w_sf = self._spmm_w_split_f if sp_fwd is not None else None
        _spmm_w_sb = self._spmm_w_split_b if sp_bwd is not None else None

        def _w_fwd_op(x, w):
            if _spmm_w_sf is not None:
                return _spmm_w_sf(pad_d(x), w, *sp_fwd)[:, : x.shape[1]]
            return _spmm_w(pad_d(x), w, *w_fwd_args)[:, : x.shape[1]]

        def _w_bwd_op(x, w):
            if _spmm_w_sb is not None:
                return _spmm_w_sb(pad_d(x), w, *sp_bwd)[:, : x.shape[1]]
            return _spmm_w_t(pad_d(x), w, *w_bwd_args)[:, : x.shape[1]]

        # ---- public custom_vjp ops (mirror TiledGraph._make_ops) ----------
        @jax.custom_vjp
        def spmm(x):
            if _spmm_sf is not None:
                return _spmm_sf(pad_d(x), *sp_fwd)[:, : x.shape[1]]
            return _spmm_u(pad_d(x), zero_w, *u_fwd_args)[:, : x.shape[1]]

        def spmm_fwd(x):
            return spmm(x), None

        def spmm_bwd(_, dy):
            if _spmm_sb is not None:
                return (_spmm_sb(pad_d(dy), *sp_bwd)[:, : dy.shape[1]],)
            return (_spmm_u(pad_d(dy), zero_w, *u_bwd_args)[:, : dy.shape[1]],)

        spmm.defvjp(spmm_fwd, spmm_bwd)

        @jax.custom_vjp
        def spmm_weighted(x, w):
            return _w_fwd_op(x, w)

        def spmm_weighted_fwd(x, w):
            return spmm_weighted(x, w), (x, w)

        def spmm_weighted_bwd(res, dy):
            x, w = res
            dx = _w_bwd_op(dy, w)
            dw = _sddmm(pad_d(dy), pad_d(x), *sddmm_args)
            return dx, dw

        spmm_weighted.defvjp(spmm_weighted_fwd, spmm_weighted_bwd)

        @jax.custom_vjp
        def sddmm(x):
            xp = pad_d(x)
            return _sddmm(xp, xp, *sddmm_args)

        def sddmm_fwd(x):
            return sddmm(x), x

        def sddmm_bwd(x, de):
            d_rows = _w_fwd_op(x, de)
            d_cols = _w_bwd_op(x, de)
            return (d_rows + d_cols,)

        sddmm.defvjp(sddmm_fwd, sddmm_bwd)

        # ---- fused AGNN aggregation (see local_agnn_* in _build_ops) -------
        agnn_aggregate = None
        if ag_meta is not None and self._agnn_fwd_sm is not None:
            _ag_fwd, _ag_bwd = self._agnn_fwd_sm, self._agnn_bwd_sm

            @jax.custom_vjp
            def agnn_aggregate(x, att_w):
                cbar = jnp.mean(att_w)
                return cbar * _ag_fwd(pad_d(x), *ag_meta)[:, : x.shape[1]]

            def ag_fwd(x, att_w):
                return agnn_aggregate(x, att_w), (x, att_w)

            def ag_bwd(res, dy):
                x, att_w = res
                cbar = jnp.mean(att_w)
                dx, dc = _ag_bwd(pad_d(x), pad_d(dy), *ag_meta)
                datt = jnp.full(att_w.shape, dc / att_w.size, att_w.dtype)
                return cbar * dx[:, : x.shape[1]], datt

            agnn_aggregate.defvjp(ag_fwd, ag_bwd)

        return spmm, spmm_weighted, sddmm, agnn_aggregate


class BoundDistributedGraph:
    """A DistributedTiledGraph's op surface over traced array values."""

    def __init__(self, parent: DistributedTiledGraph, ops):
        self.spmm, self.spmm_weighted, self.sddmm, self.agnn_aggregate = ops
        self.num_nodes = parent.num_nodes
        self.num_edges = parent.num_edges
        self.padded_nodes = parent.padded_nodes
        self.padded_edges = parent.padded_edges
        self.config = parent.config
        # The layer-schedule heuristics (gcn_conv) read these off the graph
        # they're handed — mirror BoundGraph so bound and unbound distributed
        # graphs pick the same aggregate/project order.
        self.dense_tiles = parent.dense_tiles
        self.block_diag = parent.block_diag


def distributed_graph_from_dataset(
    ds, mesh=None, config: TileConfig = DEFAULT_CONFIG, balance: bool | str = "auto",
    **kw,
) -> DistributedTiledGraph:
    """Build a DistributedTiledGraph from a GraphDataset.

    ``balance`` (default ``"auto"``): apply the window-granular LPT shard
    balance (``sgt.reorder.shard_balance_permutation``) when the graph is
    NOT headed for the block-diagonal path. Bandwidth orderings leave the
    end shards many times heavier than the middle ones, and the stacked
    metadata pads every shard to the max shard's block count — balancing
    cuts that max (and with it every shard's kernel grid) to ~the mean.
    NOTE: this permutes ``ds`` IN PLACE (graph, features, labels, masks),
    exactly like ``reorder_dataset``; pass ``balance=False`` to disable.
    """
    if mesh is None:
        from tcgnn.parallel.mesh import make_mesh

        mesh = make_mesh()
    pg = int(mesh.shape["graph"])
    # Never mutate ds when the caller forces block_diag=True: the
    # constructor must validate the *unpermuted* graph.
    if balance and pg > 1 and kw.get("block_diag") is not True:
        bd_possible = (
            kw.get("dense_tiles") is not False and kw.get("block_diag") is not False
        )
        probe = (
            probe_block_diag(
                ds.row_pointers, ds.column_index, ds.num_nodes, pg, config
            )
            if bd_possible
            else None
        )
        if probe is not None and probe[0]:
            kw.setdefault("_probe", probe)  # CSR unchanged: reuse the gate
        else:
            from tcgnn.sgt.reorder import balance_dataset

            balance_dataset(ds, pg, config)
            # The probe said no (or BD was disabled); the balanced graph
            # cannot be banded either — skip re-extraction in __init__.
            kw.setdefault("block_diag", False)
            if probe is not None:
                # symmetry is invariant under the node relabeling
                kw.setdefault("_symmetric", probe[3])
    return DistributedTiledGraph(
        ds.row_pointers, ds.column_index, ds.num_nodes, mesh, config, **kw
    )
