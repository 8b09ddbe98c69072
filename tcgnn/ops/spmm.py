"""SpMM over SGT-tiled graphs (TC-GNN's tensor-core aggregation).

Counterpart of ``spmm_forward_cuda_kernel`` / ``spmmAGNN_forward_cuda_kernel``
(/root/reference/TCGNN_conv/TCGNN_kernel.cu:336-454, 459-578).  The CUDA
kernel assigns a thread block per 16-row window, builds a binary (or
attention-weighted) A-tile in shared memory from ``edgeToColumn/edgeToRow``,
gathers the window's condensed neighbour rows, and runs a WMMA
``acc += A @ X_gathered``.

Routes, all with the same semantics as ``ops.reference.spmm_ref``:

* **dense tiles** (``spmm_tc_dense``) — the SGT-condensed A-tiles are
  materialized once at preprocessing as ``[B, blk_h, blk_w]`` blocks (the
  format whose footprint the reference reports as ``Exp_Edges``,
  TCGNN.cpp:225).  The plain form is a batched tile matmul plus a sorted
  ``segment_sum`` into window rows.  On the GPU at hub-graph size a Pallas
  Triton kernel (``_spmm_dense_triton``) gathers each window's condensed
  rows on chip and keeps partial sums in registers, writing no per-block
  intermediate.  The choice is made in one place,
  :func:`dense_spmm_impl`.
* **edge chunks** (``spmm_tc``) — graphs whose dense index space overflows
  int32 or the memory budget keep per-edge chunk metadata; the aggregation
  is a weighted row gather plus a ``segment_sum`` over output rows.
* **streamed** (``spmm_tc_streamed``) — the chunk form scanned over window
  segments so per-step working sets stay bounded (``sgt/stream.py``).
* **block-diagonal** (``spmm_block_diag``) — banded graphs run as one
  batched ``[bn, K*bn] x [K*bn, d]`` matmul per bin.
* **score-fused AGNN** (``spmm_sfused*`` / ``bd_sfused*``) — the weighted
  aggregation ``(A ⊙ (Xl Xrᵀ)) Xv`` and its one-pass backward, as score
  einsum, mask and value einsum.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tcgnn.config import TileConfig
from tcgnn.sgt.translate import JaxSGTMeta


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _precision(compute_dtype):
    """f32 compute asks for full-precision products (no TF32 on the GPU);
    bf16 compute takes the tensor cores' native path (exact for the 0/1
    structural operands)."""
    if compute_dtype == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


# ---------------------------------------------------------------------------
# Dense-tile SpMM: SGT's condensed A-tiles as dense [B, blk_h, blk_w] blocks.
# ---------------------------------------------------------------------------
def build_a_tiles(
    meta: JaxSGTMeta,
    edge_weights: jnp.ndarray | None = None,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Materialize dense A-tiles [B, blk_h, blk_w] from SGT edge positions.

    Unweighted tiles are static per graph (built once at preprocessing);
    weighted tiles are a single XLA scatter-add per call (duplicate CSR
    edges sum, matching the chunk form's per-edge accumulation).
    """
    cfg = meta.config
    size = meta.num_blocks * cfg.blk_h * cfg.blk_w
    vals = (
        jnp.ones((meta.num_edges,), dtype)
        if edge_weights is None
        else edge_weights.astype(dtype)
    )
    flat = jnp.zeros((size,), dtype).at[meta.edge_pos].add(vals)
    return flat.reshape(meta.num_blocks, cfg.blk_h, cfg.blk_w)


def _is_pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


_forced_impl = None


@contextlib.contextmanager
def forced_dense_impl(name: str):
    """Trace the dense-tile SpMM as ``name`` (``"triton"`` or ``"plain"``)
    inside this block — for timing one against the other on the card."""
    global _forced_impl
    assert name in ("triton", "plain"), name
    prev, _forced_impl = _forced_impl, name
    try:
        yield
    finally:
        _forced_impl = prev


# The Triton kernel runs on graphs with at least this many tile blocks.
# Measured on the H100 (PERF.md): on amazon0601 (11,942 blocks) the kernel
# is faster than the plain form at d=96 and d=16 and 24-34% faster per GCN
# epoch; on pubmed (356 blocks) the plain form is faster at d=16 and d=500
# and 7-11% faster per epoch.
TRITON_MIN_BLOCKS = 4096


def dense_spmm_impl(
    cfg: TileConfig,
    platform: str | None = None,
    *,
    num_blocks: int = 0,
    d: int = 0,
) -> str:
    """Which implementation the dense-tile SpMM runs: ``"triton"`` or
    ``"plain"``.

    The one place the choice is made.  ``cpu``, the test platform, runs
    the plain form.  ``gpu`` runs the Triton kernel when the tile geometry
    suits it (power-of-two ``blk_h``/``blk_w`` of at least 16, the
    smallest ``pl.dot`` operand) and the graph has at least
    ``TRITON_MIN_BLOCKS`` blocks; otherwise the plain form, which writes
    an f32 ``[blk_h, d]`` product per block and wins on small graphs.
    Any other platform is an error, not a silent fallback.
    """
    platform = jax.default_backend() if platform is None else platform
    if platform == "cpu":
        return "plain"
    if platform != "gpu":
        raise RuntimeError(
            f"no SpMM implementation for platform {platform!r} "
            "(expected gpu or cpu)"
        )
    if _forced_impl is not None:
        return _forced_impl
    fits = (
        _is_pow2(cfg.blk_h) and _is_pow2(cfg.blk_w)
        and cfg.blk_h >= 16 and cfg.blk_w >= 16
    )
    del d  # the measured crossover did not depend on the width
    return "triton" if fits and num_blocks >= TRITON_MIN_BLOCKS else "plain"


def _window_rows(x, block_window, num_windows, blk_h):
    """Per-block window rows ``[B, blk_h, d]`` of a row-major source.

    The source may exceed the window span (distributed extended slabs
    carry halo rows after the local ones) — trim, then zero-pad.
    """
    x = x[: num_windows * blk_h]
    x = jnp.pad(x, ((0, num_windows * blk_h - x.shape[0]), (0, 0)))
    return x.reshape(num_windows, blk_h, x.shape[1])[block_window]


def _gather_blocks(x, col_ids, blk_w):
    """Condensed neighbour rows ``[B, blk_w, d]``; out-of-range ids read 0."""
    xg = jnp.take(x, col_ids, axis=0, fill_value=0)
    return xg.reshape(-1, blk_w, x.shape[1])


def _window_sum(block_out, block_window, num_windows, out_dtype):
    """Fold per-block ``[B, blk_h, d]`` outputs into ``[W*blk_h, d]``.

    A sorted segment-sum over output ROWS: the equivalent sum over whole
    [blk_h, d] block slices failed at run time on the H100 at hub-graph
    size (12k blocks of 512 rows).
    """
    nb, blk_h, d = block_out.shape
    rows = (
        block_window[:, None] * blk_h + jnp.arange(blk_h, dtype=jnp.int32)
    ).reshape(-1)
    out = jax.ops.segment_sum(
        block_out.reshape(nb * blk_h, d), rows,
        num_segments=num_windows * blk_h, indices_are_sorted=True,
    )
    return out.astype(out_dtype)


@functools.partial(jax.jit, static_argnames=("cfg", "num_windows"))
def _spmm_dense_plain(x, a_tiles, col_ids, block_window, *, cfg, num_windows):
    """Plain form: batched tile matmul + sorted window segment-sum."""
    ct = cfg.compute_dtype
    xg = _gather_blocks(x.astype(ct), col_ids, cfg.blk_w)
    block_out = jnp.einsum(
        "bik,bkd->bid", a_tiles.astype(ct), xg,
        preferred_element_type=jnp.float32, precision=_precision(ct),
    )
    return _window_sum(block_out, block_window, num_windows, ct)


# Triton tiling.  A work item is a run of consecutive
# blocks of one window, so a window that holds most of a hub graph's
# blocks spreads over many programs instead of running on one SM; each
# item adds its partial sum into the output with atomics.
TRITON_MAX_D_BLOCK = 128


def _triton_tiling(num_blocks: int, d_blk: int) -> tuple[int, int]:
    """(blocks per work item, rows per program), the best of a sweep on
    the H100 (PERF.md): short items and 32-row slices on small graphs,
    long items and 64-row slices at hub-graph size and width."""
    split = 32 if num_blocks >= TRITON_MIN_BLOCKS else 8
    r_blk = 64 if d_blk >= 64 else 32
    return split, r_blk


def _triton_d_block(d: int) -> int:
    """Feature-slice width: a power of two, at least 16 (``pl.dot``'s
    smallest operand), at most 128."""
    return min(TRITON_MAX_D_BLOCK, 1 << max(4, (max(d, 1) - 1).bit_length()))


def _work_items(block_window, num_windows, split):
    """Split each window's contiguous block range into items of at most
    ``split`` blocks: ``(start, end, window)`` per item, over a static
    upper bound of ``num_windows + ceil(B / split)`` items (unused items
    have ``start == end``)."""
    nb = block_window.shape[0]
    cnt = jnp.zeros((num_windows,), jnp.int32).at[block_window].add(
        1, mode="drop"
    )
    wstart = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt, dtype=jnp.int32)]
    )
    nch = (cnt + split - 1) // split
    cum = jnp.cumsum(nch, dtype=jnp.int32)
    items = jnp.arange(num_windows + -(-nb // split), dtype=jnp.int32)
    # One fused comparison (items x windows) — small, and one kernel.
    w = jnp.sum(cum[None, :] <= items[:, None], axis=1, dtype=jnp.int32)
    valid = w < num_windows
    wc = jnp.minimum(w, num_windows - 1)
    start = wstart[wc] + (items - (cum[wc] - nch[wc])) * split
    end = jnp.minimum(start + split, wstart[wc + 1])
    return (
        jnp.where(valid, start, 0), jnp.where(valid, end, 0), wc,
    )


def _spmm_dense_kernel(
    start_ref, end_ref, win_ref, cols_ref, a_ref, x_ref, zero_ref, o_ref,
    *, blk_h, blk_w, r_blk, d_blk, compute_dtype,
):
    """One program per (work item, row slice, feature slice).

    A loop over the item's block range takes the place of a sequential
    grid: each step loads the block's ``blk_w`` column ids, gathers those
    feature rows, and accumulates ``A_tile @ X_gathered`` in registers.
    The item's partial sum is added into the window's rows once.
    """
    del zero_ref  # aliased to o_ref: the zero-initialized output
    i = pl.program_id(0)
    r = pl.program_id(1)
    dd = pl.program_id(2)
    start, end = start_ref[i], end_ref[i]
    prec = _precision(compute_dtype)

    def body(b, acc):
        cols = cols_ref[pl.ds(b * blk_w, blk_w)]
        xg = x_ref[cols, pl.ds(dd * d_blk, d_blk)]
        a = a_ref[b, pl.ds(r * r_blk, r_blk), :]
        return acc + pl.dot(
            a.astype(compute_dtype), xg.astype(compute_dtype), precision=prec
        )

    @pl.when(start < end)
    def _():
        acc = jax.lax.fori_loop(
            start, end, body, jnp.zeros((r_blk, d_blk), jnp.float32)
        )
        rows = pl.ds(win_ref[i] * blk_h + r * r_blk, r_blk)
        plgpu.atomic_add(o_ref, (rows, pl.ds(dd * d_blk, d_blk)), acc)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "num_windows", "interpret", "split", "r_blk"),
)
def _spmm_dense_triton(
    x, a_tiles, col_ids, block_window, *, cfg, num_windows, interpret=False,
    split=None, r_blk=None,
):
    """Dense-tile SpMM as a Pallas Triton kernel; ``[W*blk_h, d]``.

    ``block_window`` must be non-decreasing (every SGT layout, padded or
    partitioned, keeps a window's blocks consecutive), so each window's
    blocks are one contiguous range located by a ``searchsorted``.
    Accumulation is f32; the atomic adds make the summation order vary
    from run to run in the last bits.
    """
    ct = cfg.compute_dtype
    blk_h, blk_w = cfg.blk_h, cfg.blk_w
    n, d = x.shape
    d_blk = _triton_d_block(d)
    d_pad = _round_up(d, d_blk)
    auto_split, auto_r = _triton_tiling(a_tiles.shape[0], d_blk)
    split = auto_split if split is None else split
    r_blk = min(auto_r if r_blk is None else r_blk, blk_h)
    # Row n is all zero: out-of-range column ids (partition sentinels) read
    # it, the same zero fill the plain form's gather gives.
    xp = jnp.pad(x.astype(ct), ((0, 1), (0, d_pad - d)))
    cols = jnp.where((col_ids >= 0) & (col_ids < n), col_ids, n)
    start, end, win = _work_items(block_window, num_windows, split)
    kernel = functools.partial(
        _spmm_dense_kernel, blk_h=blk_h, blk_w=blk_w, r_blk=r_blk,
        d_blk=d_blk, compute_dtype=ct,
    )
    zeros = jnp.zeros((num_windows * blk_h, d_pad), jnp.float32)
    out = pl.pallas_call(
        kernel,
        grid=(start.shape[0], blk_h // r_blk, d_pad // d_blk),
        in_specs=[pl.no_block_spec] * 7,
        out_specs=pl.no_block_spec,
        out_shape=jax.ShapeDtypeStruct(zeros.shape, jnp.float32),
        input_output_aliases={6: 0},
        backend="triton",
        # 4 warps, no software pipelining: the loop's loads depend on the
        # column ids it just read (best of the sweep in PERF.md).
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="tcgnn_dense_spmm",
    )(start, end, win, cols.astype(jnp.int32), a_tiles, xp, zeros)
    return out[:, :d].astype(ct)


def _spmm_dense_padded(x, a_tiles, col_ids, block_window, *, cfg, num_windows):
    """Dense-tile SpMM ``[W*blk_h, d]`` in the compute dtype, through the
    implementation :func:`dense_spmm_impl` picks."""
    impl = dense_spmm_impl(cfg, num_blocks=a_tiles.shape[0], d=x.shape[1])
    fn = _spmm_dense_triton if impl == "triton" else _spmm_dense_plain
    return fn(x, a_tiles, col_ids, block_window, cfg=cfg, num_windows=num_windows)


def spmm_tc_dense(
    x: jnp.ndarray,
    meta: JaxSGTMeta,
    a_tiles: jnp.ndarray,
) -> jnp.ndarray:
    """Tensor-core SpMM via pre-materialized dense A-tiles: ``out = A @ x``."""
    n, d = x.shape
    out = _spmm_dense_padded(
        x, a_tiles, meta.col_ids, meta.block_window,
        cfg=meta.config, num_windows=meta.num_windows,
    )
    return out[:n, :d]


@functools.partial(
    jax.jit, static_argnames=("padded_blocks", "blk_h", "blk_w", "out_dtype")
)
def _build_struct_tiles_padded(
    edge_pos, *, padded_blocks, blk_h, blk_w, out_dtype=None
):
    flat = jnp.zeros((padded_blocks * blk_h * blk_w,), jnp.int32)
    # padding slots carry an out-of-range sentinel; drop them explicitly
    flat = flat.at[edge_pos].add(1, mode="drop")
    tiles = flat.reshape(padded_blocks, blk_h, blk_w)
    if out_dtype is not None:
        # Storage dtype decided host-side (duplicate-count max is known from
        # the translate pass) — the cast rides the scatter program, so prep
        # dispatches ONE device program and never syncs on a value.
        return tiles.astype(out_dtype)
    return tiles, jnp.max(tiles)


def build_struct_tiles(edge_pos, *, num_blocks, blk_h, blk_w, out_dtype=None):
    """Structural A-tiles [B, blk_h, blk_w] from per-edge flat positions.

    Runs on the device: the host ships ``edge_pos`` (4 bytes/edge — needed
    by the weighted paths anyway) instead of the materialized dense tile
    array (``blk_h*blk_w`` bytes per block).  With ``out_dtype`` set, the
    storage cast is fused into the scatter program and only the tile array
    is returned — the caller decides int8-exactness host-side
    (``sgt/translate.py`` overflow rule) and nothing forces a device sync.
    Without it, returns int32 counts plus their max.

    The scatter compiles per input and output shape, so both dimensions
    are bucketed to the next power of two (edge padding carries an
    out-of-range sentinel the scatter drops; ≤2x transient memory on the
    block side) and the result sliced back — the graphs of a sweep share a
    handful of compilations in the persistent cache.
    """
    cap = (2**31 - 1) // (blk_h * blk_w)  # edge_pos is int32 (translate.py)
    padded = 1 << max(8, (num_blocks - 1).bit_length())
    if padded > cap:
        padded = min(cap, -(-num_blocks // 1024) * 1024)
    e = edge_pos.shape[0]
    e_bucket = 1 << max(12, (e - 1).bit_length())
    if e_bucket != e:
        sentinel = padded * blk_h * blk_w  # out of range -> dropped
        edge_pos = jnp.pad(edge_pos, (0, e_bucket - e), constant_values=sentinel)
    out = _build_struct_tiles_padded(
        edge_pos, padded_blocks=padded, blk_h=blk_h, blk_w=blk_w,
        out_dtype=out_dtype,
    )
    if out_dtype is not None:
        return out[:num_blocks]
    tiles, mx = out
    return tiles[:num_blocks], mx


# ---------------------------------------------------------------------------
# Edge-chunk SpMM: per-edge chunk metadata (row-in-window, column-in-block,
# block, window), as a weighted row gather + segment_sum over output rows.
# ---------------------------------------------------------------------------
def _chunk_rows_cols(col_ids, chunk_r, chunk_c, chunk_block, chunk_window,
                     blk_h, blk_w):
    """Output row and source node of every chunk slot.  Padding slots
    (``chunk_r == blk_h``) get output row -1, which ``segment_sum`` drops."""
    valid = chunk_r < blk_h
    rows = jnp.where(valid, chunk_window[:, None] * blk_h + chunk_r, -1)
    slot = chunk_block[:, None] * blk_w + chunk_c
    src = jnp.take(col_ids, slot, fill_value=0)
    return rows, src, valid


@functools.partial(
    jax.jit, static_argnames=("cfg", "num_windows", "weighted"),
)
def _spmm_padded(
    x, col_ids, chunk_r, chunk_c, chunk_w, chunk_block, chunk_window,
    *, cfg: TileConfig, num_windows: int, weighted: bool,
) -> jnp.ndarray:
    """Chunk SpMM; returns ``[num_windows * blk_h, d]`` f32."""
    ct = cfg.compute_dtype
    rows, src, _ = _chunk_rows_cols(
        col_ids, chunk_r, chunk_c, chunk_block, chunk_window,
        cfg.blk_h, cfg.blk_w,
    )
    xg = jnp.take(x.astype(ct), src.reshape(-1), axis=0, fill_value=0)
    xg = xg.astype(jnp.float32)
    if weighted:
        xg = xg * chunk_w.reshape(-1, 1).astype(ct).astype(jnp.float32)
    return jax.ops.segment_sum(
        xg, rows.reshape(-1), num_segments=num_windows * cfg.blk_h
    )


def spmm_tc(
    x: jnp.ndarray,
    meta: JaxSGTMeta,
    edge_weights: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Chunk-metadata SpMM: ``out = A @ x`` (optionally edge-weighted).

    Args:
      x: node features [N, D] (any float dtype; accumulation is f32).
      meta: SGT tiling of A (CSR rows = output nodes).
      edge_weights: per-CSR-edge weights [num_edges] for the AGNN path
        (``spmmAGNN_forward_cuda``, TCGNN_kernel.cu:459-578); None = binary A.

    Returns:
      [N, D] f32 aggregated features.
    """
    n, d = x.shape
    if edge_weights is None:
        weighted = False
        chunk_w = jnp.zeros_like(meta.chunk_r)  # unused placeholder
    else:
        weighted = True
        w_padded = jnp.concatenate(
            [edge_weights.astype(jnp.float32), jnp.zeros((1,), jnp.float32)]
        )
        chunk_w = w_padded[meta.chunk_edge_id]
    out = _spmm_padded(
        x, meta.col_ids, meta.chunk_r, meta.chunk_c, chunk_w,
        meta.chunk_block, meta.chunk_window,
        cfg=meta.config, num_windows=meta.num_windows, weighted=weighted,
    )
    return out[:n, :d]


# ---------------------------------------------------------------------------
# Window-segment streamed chunk path (sgt/stream.py): lax.scan the chunk form
# over S stacked uniform segments, so each step's gathered rows and chunk
# metadata stay bounded while the full feature matrix (O(N*D)) is resident.
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("cfg", "wseg", "weighted"))
def _spmm_streamed_padded(
    x, w_tbl, seg_col_ids, seg_r, seg_c, seg_edge_id, seg_block, seg_window,
    *, cfg: TileConfig, wseg: int, weighted: bool,
) -> jnp.ndarray:
    """Streamed chunk SpMM; returns [S * wseg * blk_h, D] f32.

    Each scan step is one `_spmm_padded` segment call with segment-relative
    window ids.  Per-chunk edge weights are gathered from ``w_tbl``
    (num_edges + 1 entries; the sentinel reads the appended zero) inside
    the step so no [Cn, EC] weight array is ever resident.
    """
    num_segments = seg_r.shape[0]

    def step(_, seg):
        col_ids, r, c, eid, blk, win = seg
        cw = w_tbl[eid] if weighted else jnp.zeros(r.shape, jnp.float32)
        out_s = _spmm_padded(
            x, col_ids, r, c, cw, blk, win,
            cfg=cfg, num_windows=wseg, weighted=weighted,
        )
        return None, out_s

    _, outs = jax.lax.scan(
        step, None,
        (seg_col_ids, seg_r, seg_c, seg_edge_id, seg_block, seg_window),
    )
    return outs.reshape(num_segments * wseg * cfg.blk_h, x.shape[1])


def spmm_tc_streamed(
    x: jnp.ndarray,
    smeta,
    edge_weights: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Streamed SpMM: ``out = A @ x`` over window segments.

    ``smeta`` is a :class:`tcgnn.sgt.stream.StreamedJaxMeta`.  Same
    semantics as :func:`spmm_tc` (TCGNN_kernel.cu:336-454 /459-578).
    """
    n, d = x.shape
    if edge_weights is None:
        weighted = False
        w_tbl = jnp.zeros((1,), jnp.float32)
    else:
        weighted = True
        w_tbl = jnp.concatenate(
            [edge_weights.astype(jnp.float32), jnp.zeros((1,), jnp.float32)]
        )
    out = _spmm_streamed_padded(
        x, w_tbl,
        smeta.seg_col_ids, smeta.seg_r, smeta.seg_c, smeta.seg_edge_id,
        smeta.seg_block, smeta.seg_window,
        cfg=smeta.config, wseg=smeta.wseg, weighted=weighted,
    )
    return out[:n, :d]


# ---------------------------------------------------------------------------
# Block-diagonal path (see sgt/blockdiag.py): for banded/component graphs the
# SpMM collapses to uniform batched [bin, K*bin] x [K*bin, d] matmuls — no
# gather of individual rows, no window bookkeeping.
# ---------------------------------------------------------------------------
# Bin padding granule of the packed block-diagonal tile layout.
BD_BIN_GROUP = 8


def _bd_stack(x, nbins, bn, offsets, ct):
    """Halo stack ``xs[b] = vstack(x_bin[b+k] for k in offsets)``.

    [nbins, K*bn, d]: the vertical stack of each bin's K shifted feature
    bins — the right operand for every packed-[bn, K*bn]-tile contraction.
    Zero rim bins stand in for wrap-around: a reader of x[b+k] out of range
    multiplies all-zero tiles anyway.  K static slices + stack (plain
    contiguous copies).
    """
    n, d = x.shape
    # Normalize the halo range to include 0 so pads/slices stay in-bounds
    # even when every selected offset is one-signed (a strictly upper- or
    # lower-triangular banded graph has no diagonal-0 stream).
    kmin, kmax = min(0, min(offsets)), max(0, max(offsets))
    xb = x.astype(ct)
    xb = jnp.pad(
        xb, ((-kmin * bn, (nbins * bn - n) + kmax * bn), (0, 0))
    ).reshape(nbins + (kmax - kmin), bn, d)
    return jnp.stack(
        [xb[k - kmin:k - kmin + nbins] for k in offsets], axis=1
    ).reshape(nbins, len(offsets) * bn, d)


def _bd_bins(x, nbins, bn, ct):
    """Row bins ``[nbins, bn, d]`` of x, zero-padded past its last row."""
    x = jnp.pad(x.astype(ct), ((0, nbins * bn - x.shape[0]), (0, 0)))
    return x.reshape(nbins, bn, x.shape[1])


@functools.partial(jax.jit, static_argnames=("offsets", "cfg"))
def _spmm_bd_core(x, tiles, *, offsets: tuple, cfg: TileConfig):
    """``out[b] = sum_k D_k[b] @ x[b + k]`` as ONE batched matmul.

    The K diagonal streams collapse into a single [bin, K*bin] x [K*bin, d]
    contraction per bin: the packed tile row multiplies the vertical stack
    of the bin's K shifted feature bins.
    """
    ct = cfg.compute_dtype
    nbins, bn = tiles.shape[0], tiles.shape[1]
    xs = _bd_stack(x, nbins, bn, offsets, ct)
    out = jnp.einsum(
        "bik,bkd->bid", tiles.astype(ct), xs,
        preferred_element_type=jnp.float32, precision=_precision(ct),
    )
    return out.reshape(nbins * bn, x.shape[1]).astype(ct)


def spmm_block_diag(
    x: jnp.ndarray,
    tiles: jnp.ndarray,
    *,
    offsets: tuple,
    cfg: TileConfig,
) -> jnp.ndarray:
    """Block-diagonal SpMM: ``out = A_bd @ x`` (covered offsets only).

    ``tiles`` is the packed [B, bin, K*bin] layout (``build_bd_pack``).
    The caller adds the residual-edge contribution (condensed path) when
    coverage < 1; see ``TiledGraph._make_ops``.
    """
    return _spmm_bd_core(x, tiles, offsets=offsets, cfg=cfg)[
        : x.shape[0], : x.shape[1]
    ]


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_edges", "cap", "chunk_bins", "n_chunks", "bn", "offsets", "cfg",
    ),
)
def bd_sddmm_edges(
    xa, xb, pos_pad, e_start, *,
    num_edges, cap, chunk_bins, n_chunks, bn, offsets, cfg,
):
    """Per-edge BD SDDMM: ``e[i] = <xa[row_i], xb[col_i]>`` in CSR order.

    Computes only the edge dots, not every cell of the [Bp, bn, K*bn]
    pack: a ``fori_loop`` over bin chunks where each step row-gathers the
    chunk's edges' xa/xb rows from chunk-local slices and reduces their
    elementwise product.  Per-edge results land at
    ``dynamic_update_slice(out, vals, e_start[ci])``: packed positions are
    non-decreasing in CSR edge order (bin-major pack, row-major edges), so
    each chunk's edges are one contiguous range and a later chunk's write
    overwrites the previous chunk's padding garbage — no compaction gather.

    ``pos_pad`` is the per-edge packed position (monotone; residual edges
    carry their predecessor's position and are overwritten by the caller's
    residual merge), padded by ``cap`` so every chunk can slice a full
    window.  Plays the role of the reference's SDDMM kernel
    (TCGNN_kernel.cu:584-728).
    """
    ct = cfg.compute_dtype
    k = len(offsets)
    kw = k * bn
    d = xa.shape[1]
    bp_pad = n_chunks * chunk_bins
    kmin, kmax = min(0, min(offsets)), max(0, max(offsets))
    n = xa.shape[0]
    xa_p = jnp.pad(xa.astype(ct), ((0, bp_pad * bn - n), (0, 0)))
    xb_p = jnp.pad(
        xb.astype(ct), ((-kmin * bn, (bp_pad * bn - n) + kmax * bn), (0, 0))
    )
    out = jnp.zeros((num_edges + cap,), jnp.float32)

    def step(ci, out):
        b0 = ci * chunk_bins
        xa_c = jax.lax.dynamic_slice_in_dim(
            xa_p, b0 * bn, chunk_bins * bn, 0
        )
        parts = [
            jax.lax.dynamic_slice_in_dim(
                xb_p, (b0 + off - kmin) * bn, chunk_bins * bn, 0
            ).reshape(chunk_bins, bn, d)
            for off in offsets
        ]
        # [CB, K, bn, d] -> flat rows addressed by b_loc*K*bn + j.
        xs_c = jnp.stack(parts, axis=1).reshape(chunk_bins * kw, d)
        es = e_start[ci]
        p = jax.lax.dynamic_slice_in_dim(pos_pad, es, cap, 0)
        r_loc = p // kw - b0 * bn          # packed row within the chunk
        j = p % kw                          # lane within the packed row
        ga = jnp.take(xa_c, r_loc, axis=0, mode="clip")
        gb = jnp.take(xs_c, (r_loc // bn) * kw + j, axis=0, mode="clip")
        # f32 products + f32 accumulation: the condensed SDDMM's precision
        # contract — a bf16 product would round each term to 8 bits first.
        vals = jnp.sum(
            ga.astype(jnp.float32) * gb.astype(jnp.float32), axis=1
        )
        return jax.lax.dynamic_update_slice(out, vals, (es,))

    out = jax.lax.fori_loop(0, n_chunks, step, out)
    return out[:num_edges]


def bd_scatter_weights(w_cov, cov_pack_idx, *, bp, bn, k, dtype):
    """Per-edge weights -> packed [Bp, bn, K*bn] weighted tiles.

    Duplicate edges scatter-add onto the same cell, matching the structural
    pack's duplicate counts (``A_w[i,j] = sum_{e=(i,j)} w_e``).
    """
    flat = jnp.zeros((bp * bn * k * bn,), dtype)
    flat = flat.at[cov_pack_idx].add(w_cov.astype(dtype))
    return flat.reshape(bp, bn, k * bn)


@functools.partial(jax.jit, static_argnames=("k", "nbins", "bn"))
def build_bd_pack(tile_idx, tile_cnt, *, k, nbins, bn) -> jnp.ndarray:
    """Sparse (idx, cnt) tile contents -> the packed [Bp, bin, K*bin] layout.

    Runs on the device: the host ships only the nonzero entries (~bytes per
    edge) instead of materializing, transposing, and uploading the full
    mostly-zero pack.  ``Bp`` is B rounded up to ``BD_BIN_GROUP`` (padding
    bins are all-zero, so they contribute nothing and their outputs are
    sliced away).
    """
    flat = jnp.zeros((k * nbins * bn * bn,), tile_cnt.dtype)
    flat = flat.at[tile_idx].set(tile_cnt, indices_are_sorted=True,
                                 unique_indices=True)
    packed = (
        flat.reshape(k, nbins, bn, bn)
        .transpose(1, 2, 0, 3)
        .reshape(nbins, bn, k * bn)
    )
    bp = _round_up(max(nbins, 1), BD_BIN_GROUP)
    if bp != nbins:
        packed = jnp.pad(packed, ((0, bp - nbins), (0, 0), (0, 0)))
    return packed


# ---------------------------------------------------------------------------
# Score-fused AGNN aggregation.  Every AGNN train-step term is an instance of
#
#     out = (A ⊙ (Xl @ Xrᵀ)) @ Xv
#
# (graph symmetric, S = X Xᵀ):
#   forward   u   = (A ⊙ (x @ xᵀ))  @ x          l=x,  r=x,  v=x
#   backward  t1  = (A ⊙ (x @ xᵀ))  @ dy         l=x,  r=x,  v=dy
#             t2a = (A ⊙ (dy @ xᵀ)) @ x          l=dy, r=x,  v=x
#             t2b = (A ⊙ (dy @ xᵀ))ᵀ @ x
#                 = (A ⊙ (x @ dyᵀ)) @ x          l=x,  r=dy, v=x
# using (M ⊙ T)ᵀ = Mᵀ ⊙ Tᵀ and A = Aᵀ — so no transpose-space pass exists in
# the backward.  Reference counterpart: the AGNN kernel pair
# TCGNN_kernel.cu:459-578 + 584-728.  Here each is a score einsum, a mask
# and a value einsum; the score tiles are written to device memory once
# per term (a fused kernel that keeps them on chip is an open item).
# ---------------------------------------------------------------------------
def _nt(a, b, ct):
    """``a @ bᵀ`` batched over the leading dim, f32 accumulation."""
    return jnp.einsum(
        "bid,bkd->bik", a, b,
        preferred_element_type=jnp.float32, precision=_precision(ct),
    )


def _nn(a, b, ct):
    """``a @ b`` batched over the leading dim, f32 accumulation."""
    return jnp.einsum(
        "bik,bkd->bid", a, b,
        preferred_element_type=jnp.float32, precision=_precision(ct),
    )


@functools.partial(jax.jit, static_argnames=("offsets", "cfg", "share_rv"))
def _bd_sfused_core(xl, xr, xv, tiles, *, offsets, cfg, share_rv):
    ct = cfg.compute_dtype
    nbins, bn = tiles.shape[0], tiles.shape[1]
    xs = _bd_stack(xr, nbins, bn, offsets, ct)
    vs = xs if share_rv else _bd_stack(xv, nbins, bn, offsets, ct)
    s = _nt(_bd_bins(xl, nbins, bn, ct), xs, ct)
    w = tiles.astype(ct) * s.astype(ct)
    out = _nn(w, vs, ct)
    return out.reshape(nbins * bn, xr.shape[1]).astype(ct)


def bd_sfused(
    xl: jnp.ndarray,
    xr: jnp.ndarray,
    xv: jnp.ndarray,
    tiles: jnp.ndarray,
    *,
    offsets: tuple,
    cfg: TileConfig,
) -> jnp.ndarray:
    """Score-fused block-diagonal SpMM:
    ``out = (C ⊙ S) @ xv`` with ``S(i, j) = <xl[i], xr[j]>`` restricted to
    the packed diagonal tiles.  ``xv is xr`` shares the halo stack."""
    n, d = xl.shape
    out = _bd_sfused_core(
        xl, xr, xv, tiles, offsets=offsets, cfg=cfg, share_rv=xv is xr
    )
    return out[:n, :d]


@functools.partial(jax.jit, static_argnames=("offsets", "cfg"))
def _bd_sfused_bwd_core(x, dy, tiles, *, offsets, cfg):
    ct = cfg.compute_dtype
    nbins, bn = tiles.shape[0], tiles.shape[1]
    xw = _bd_bins(x, nbins, bn, ct)
    dyw = _bd_bins(dy, nbins, bn, ct)
    xs = _bd_stack(x, nbins, bn, offsets, ct)
    dys = _bd_stack(dy, nbins, bn, offsets, ct)
    c = tiles.astype(ct)
    cs = c * _nt(xw, xs, ct).astype(ct)
    ctu = c * (_nt(dyw, xs, ct) + _nt(xw, dys, ct)).astype(ct)
    dx3 = _nn(cs, dys, ct) + _nn(ctu, xs, ct)
    u = _nn(cs, xs, ct)
    d = x.shape[1]
    return (
        dx3.reshape(nbins * bn, d).astype(ct),
        u.reshape(nbins * bn, d).astype(ct),
    )


def bd_sfused_bwd(
    x: jnp.ndarray,
    dy: jnp.ndarray,
    tiles: jnp.ndarray,
    *,
    offsets: tuple,
    cfg: TileConfig,
):
    """AGNN backward over packed diagonal tiles in one pass.

    Returns ``(dx3, u)`` with ``dx3 = (C⊙S)@dy + (C⊙T)@x + (C⊙U)@x`` and
    ``u = (C⊙S)@x`` (the forward product, for the attention gradient),
    where S = x xᵀ, T = dy xᵀ, U = x dyᵀ on the packed diagonals.
    """
    n, d = x.shape
    dx3, u = _bd_sfused_bwd_core(x, dy, tiles, offsets=offsets, cfg=cfg)
    return dx3[:n, :d], u[:n, :d]


@functools.partial(jax.jit, static_argnames=("cfg", "num_windows"))
def _spmm_fused_padded(x, a_tiles, s_tiles, col_ids, block_window,
                       *, cfg, num_windows):
    """Score-weighted SpMM: ``out = (A_struct * S) @ x``, [W*blk_h, d] f32,
    from precomputed score tiles (the feature-sharded distributed AGNN,
    whose scores need a cross-shard sum before use)."""
    ct = cfg.compute_dtype
    w = a_tiles.astype(ct) * s_tiles.astype(ct)
    xg = _gather_blocks(x.astype(ct), col_ids, cfg.blk_w)
    return _window_sum(_nn(w, xg, ct), block_window, num_windows, jnp.float32)


@functools.partial(jax.jit, static_argnames=("cfg", "num_windows"))
def _spmm_sfused_padded(
    xl, xr, xv, a_tiles, col_ids, block_window, *, cfg, num_windows,
):
    """Score-fused SpMM: ``out = (A ⊙ (xl @ xr_gᵀ)) @ xv_g``, [W*blk_h, d]
    f32.  ``xv=None`` shares the gathered xr rows as the value operand."""
    ct = cfg.compute_dtype
    blk_h, blk_w = cfg.blk_h, cfg.blk_w
    xl_w = _window_rows(xl.astype(ct), block_window, num_windows, blk_h)
    xr_g = _gather_blocks(xr.astype(ct), col_ids, blk_w)
    xv_g = xr_g if xv is None else _gather_blocks(xv.astype(ct), col_ids, blk_w)
    w = a_tiles.astype(ct) * _nt(xl_w, xr_g, ct).astype(ct)
    return _window_sum(_nn(w, xv_g, ct), block_window, num_windows, jnp.float32)


def spmm_sfused(
    xl: jnp.ndarray,
    xr: jnp.ndarray,
    xv: jnp.ndarray,
    meta: JaxSGTMeta,
    a_tiles: jnp.ndarray,
) -> jnp.ndarray:
    """Score-fused SpMM over SGT condensed tiles:
    ``out = (A ⊙ S) @ xv`` with ``S(i, j) = <xl[i], xr[j]>``.
    Pass ``xv is xr`` (object identity) to share the gathered rows."""
    n, d = xl.shape
    out = _spmm_sfused_padded(
        xl, xr, None if xv is xr else xv, a_tiles,
        meta.col_ids, meta.block_window,
        cfg=meta.config, num_windows=meta.num_windows,
    )
    return out[:n, :d]


@functools.partial(jax.jit, static_argnames=("cfg", "num_windows"))
def _spmm_sfused_bwd_padded(
    x, dy, a_tiles, col_ids, block_window,
    *, cfg, num_windows, xw=None, dyw=None,
):
    """One-pass AGNN backward over condensed tiles: ``(dx3, u)``, each
    [W*blk_h, d] f32.  ``xw``/``dyw`` optionally override the WINDOW-side
    sources (distributed split stream: guest windows carry owner rows, so
    the window layout differs from the gather slab); gathers always read
    ``x``/``dy`` through ``col_ids``."""
    ct = cfg.compute_dtype
    blk_h, blk_w = cfg.blk_h, cfg.blk_w
    xw = x if xw is None else xw
    dyw = dy if dyw is None else dyw
    xw_b = _window_rows(xw.astype(ct), block_window, num_windows, blk_h)
    dyw_b = _window_rows(dyw.astype(ct), block_window, num_windows, blk_h)
    xg = _gather_blocks(x.astype(ct), col_ids, blk_w)
    dyg = _gather_blocks(dy.astype(ct), col_ids, blk_w)
    a = a_tiles.astype(ct)
    cs = a * _nt(xw_b, xg, ct).astype(ct)
    ctu = a * (_nt(dyw_b, xg, ct) + _nt(xw_b, dyg, ct)).astype(ct)
    dx3 = _nn(cs, dyg, ct) + _nn(ctu, xg, ct)
    u = _nn(cs, xg, ct)
    f32 = jnp.float32
    return (
        _window_sum(dx3, block_window, num_windows, f32),
        _window_sum(u, block_window, num_windows, f32),
    )


def spmm_sfused_bwd(
    x: jnp.ndarray,
    dy: jnp.ndarray,
    meta: JaxSGTMeta,
    a_tiles: jnp.ndarray,
):
    """AGNN backward over SGT condensed tiles; returns ``(dx3, u)`` — see
    `bd_sfused_bwd` for the algebra."""
    n, d = x.shape
    dx3, u = _spmm_sfused_bwd_padded(
        x, dy, a_tiles, meta.col_ids, meta.block_window,
        cfg=meta.config, num_windows=meta.num_windows,
    )
    return dx3[:n, :d], u[:n, :d]
