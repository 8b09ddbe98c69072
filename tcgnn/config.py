"""Tiling configuration of the SGT framework.

The reference keeps its tile geometry in a compile-time C header
(``TCGNN_conv/config.h:4-6``: BLK_H=16, BLK_W=8, WARP_SIZE=32) mirrored by a
Python module (``config.py:1-9``).  Here the geometry is a runtime value:
the defaults are wider tiles, and the reference's 16x8 geometry stays
available for the SGT analytics' parity checks.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Geometry of the Sparse-Graph-Translation tiling.

    Attributes:
      blk_h: rows per row-window (output tile height).  GPU reference uses 16
        (one WMMA fragment).
      blk_w: condensed columns per TC block (contraction tile width).  GPU
        reference uses 8.
      edge_chunk: edges per uniform chunk of the edge-chunk route; each
        block's edge list is padded to a multiple of this.
      compute_dtype: dtype of the feature operands of the tile products.
        f32 for exactness in tests; bf16 for tensor-core throughput in
        benchmarks (the 0/1 structural operands are exact in bf16 either
        way).  Accumulation is f32 in both.
    """

    # The default geometry (512-row windows, 128-wide blocks, 128-edge
    # chunks, AUTO block group) was chosen on an earlier accelerator and is
    # not measured on the H100; re-deriving it from a sweep on the card is
    # ROADMAP item A4.  Taller windows dedup more neighbours per window
    # (fewer condensed-gather rows) at the price of more zero cells per
    # tile.
    blk_h: int = 512
    blk_w: int = 128
    edge_chunk: int = 128
    compute_dtype: jnp.dtype = jnp.float32
    # SGT pads every window's block count to a multiple of ``block_group``
    # (consecutive same-window blocks travel together); the padding inflates
    # the condensed gather, so sparse-window graphs want 1.  0 = AUTO:
    # TiledGraph resolves it per graph from the real block/window density
    # (>=8 blocks per window -> 2, else 1) with one extra native count pass.
    block_group: int = 1

    @property
    def row_sentinel(self) -> int:
        """Row value marking a padding edge slot.

        A row of ``blk_h`` lies outside every window, so padded slots
        contribute exactly zero (the analogue of the reference leaving
        untouched zeros in its shared-mem tile, ``TCGNN_kernel.cu:399-408``).
        """
        return self.blk_h


# Reference GPU geometry, kept for analytics parity with
# /root/reference/TCGNN_conv/config.h and 3_cnt_TC_blk_SpMM.py.
GPU_REFERENCE_CONFIG = TileConfig(blk_h=16, blk_w=8, edge_chunk=32)

# Default geometry.
DEFAULT_CONFIG = TileConfig()
