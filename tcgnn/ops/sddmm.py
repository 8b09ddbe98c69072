"""SDDMM over SGT-tiled graphs (per-edge dot-product scores).

Counterpart of ``sddmm_forward_cuda_kernel``
(/root/reference/TCGNN_conv/TCGNN_kernel.cu:584-728): the CUDA kernel tiles
a window's 16 own feature rows against its condensed neighbours' rows, runs
WMMA ``X @ Yᵀ`` into a 16x16 score tile, and scatters scores to edges via
an index matrix (lines 654-663, 719-726).

Two forms share the SpMM's metadata:

* **dense tiles** (``sddmm_tc_dense``) — score tiles
  ``S_b = Xa[window(b)] @ Xg[b]ᵀ`` as one batched matmul, per-edge scores
  read straight out of the flat tiles at ``meta.edge_pos`` (the scatter
  epilogue, TCGNN_kernel.cu:719-726, as one gather);
* **edge chunks** (``sddmm_tc``, ``sddmm_tc_streamed``) — each chunk slot
  gathers its row-side and column-side feature rows and reduces their
  product; ``edge_perm`` maps chunk slots back to CSR edge order.

Generalized to two input matrices (xa for edge rows, xb for edge columns):
``xa == xb`` gives the reference op; ``xa = dY, xb = X`` gives the exact
edge-weight gradient of the weighted SpMM, which the reference approximates
ad hoc (gnn_conv.py:150-158).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tcgnn.config import TileConfig
from tcgnn.sgt.translate import JaxSGTMeta
from tcgnn.ops.spmm import (
    _chunk_rows_cols,
    _gather_blocks,
    _nt,
    _window_rows,
)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _sddmm_padded(
    xa, xb, col_ids, chunk_r, chunk_c, chunk_block, chunk_window,
    *, cfg: TileConfig,
) -> jnp.ndarray:
    """Chunk-layout scores [n_chunks, EC] f32 (padding slots hold 0).
    Output rows index ``xa`` directly; rows past its end read 0."""
    ct = cfg.compute_dtype
    rows, src, valid = _chunk_rows_cols(
        col_ids, chunk_r, chunk_c, chunk_block, chunk_window,
        cfg.blk_h, cfg.blk_w,
    )
    a = jnp.take(xa.astype(ct), rows, axis=0, fill_value=0)
    b = jnp.take(xb.astype(ct), src, axis=0, fill_value=0)
    s = jnp.sum(a.astype(jnp.float32) * b.astype(jnp.float32), axis=-1)
    return jnp.where(valid, s, 0.0)


def sddmm_tc(
    xa: jnp.ndarray,
    meta: JaxSGTMeta,
    xb: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Chunk-metadata SDDMM: per-edge ``e_(i,j) = <xa[i], xb[j]>`` in CSR
    order.  ``xb=None`` means ``xb = xa`` (the reference op,
    ``sddmm_forward``, TCGNN.cpp:126-150)."""
    if xb is None:
        xb = xa
    scores = _sddmm_padded(
        xa, xb, meta.col_ids, meta.chunk_r, meta.chunk_c,
        meta.chunk_block, meta.chunk_window, cfg=meta.config,
    )
    return scores.reshape(-1)[meta.edge_perm]


@functools.partial(jax.jit, static_argnames=("cfg", "wseg"))
def _sddmm_streamed_padded(
    xa, xb, seg_col_ids, seg_r, seg_c, seg_block, seg_window,
    *, cfg: TileConfig, wseg: int,
) -> jnp.ndarray:
    """Streamed chunk SDDMM; returns stacked scores [S, C_max, EC] f32.

    Each step reads the segment's own window rows (a contiguous dynamic
    slice of the padded xa — windows are consecutive row ranges) and
    gathers the segment's condensed columns.
    """
    num_segments = seg_r.shape[0]
    rows = wseg * cfg.blk_h
    xa_full = jnp.pad(xa, ((0, num_segments * rows - xa.shape[0]), (0, 0)))

    def step(s, seg):
        col_ids, r, c, blk, win = seg
        xa_seg = jax.lax.dynamic_slice(
            xa_full, (s * rows, 0), (rows, xa_full.shape[1])
        )
        scores = _sddmm_padded(xa_seg, xb, col_ids, r, c, blk, win, cfg=cfg)
        return s + 1, scores

    _, outs = jax.lax.scan(
        step, 0, (seg_col_ids, seg_r, seg_c, seg_block, seg_window)
    )
    return outs


def sddmm_tc_streamed(
    xa: jnp.ndarray,
    smeta,
    xb: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Streamed SDDMM: per-edge ``e_(i,j) = <xa[i], xb[j]>`` in CSR order.

    ``smeta`` is a :class:`tcgnn.sgt.stream.StreamedJaxMeta`; same
    semantics as :func:`sddmm_tc` (TCGNN_kernel.cu:584-728).
    """
    if xb is None:
        xb = xa
    scores = _sddmm_streamed_padded(
        xa, xb,
        smeta.seg_col_ids, smeta.seg_r, smeta.seg_c,
        smeta.seg_block, smeta.seg_window,
        cfg=smeta.config, wseg=smeta.wseg,
    )
    return scores.reshape(-1)[smeta.edge_perm]


@functools.partial(
    jax.jit, static_argnames=("cfg", "num_windows", "out_dtype"),
)
def _sddmm_dense_padded(
    xa, xb, col_ids, block_window,
    *, cfg: TileConfig, num_windows: int, out_dtype=jnp.float32,
) -> jnp.ndarray:
    """Score tiles [B, blk_h, blk_w] in ``out_dtype``: one batched
    ``[blk_h, d] x [d, blk_w]`` matmul per block, f32 accumulation."""
    ct = cfg.compute_dtype
    xa_w = _window_rows(xa.astype(ct), block_window, num_windows, cfg.blk_h)
    xg = _gather_blocks(xb.astype(ct), col_ids, cfg.blk_w)
    return _nt(xa_w, xg, ct).astype(out_dtype)


def sddmm_tc_dense(
    xa: jnp.ndarray,
    meta: JaxSGTMeta,
    xb: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Dense-tile SDDMM: per-edge ``e = <xa[row_e], xb[col_e]>`` (CSR order)."""
    if xb is None:
        xb = xa
    tiles = _sddmm_dense_padded(
        xa, xb, meta.col_ids, meta.block_window,
        cfg=meta.config, num_windows=meta.num_windows,
    )
    return tiles.reshape(-1)[meta.edge_pos]
