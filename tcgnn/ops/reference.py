"""Dense/segment-sum oracle implementations of the graph ops.

These are the correctness references for the SGT tile ops —
the role the commented-out ``gen_test_tensor`` eyeball probes play in the
reference (``/root/reference/gnn_conv.py:13-23,61-71``), made into real
oracles.  Semantics:

* ``spmm``  — neighbor aggregation  ``out[i] = sum_{e=(i,j)} w_e * X[j]``
  (matches ``spmm_forward_cuda_kernel``, TCGNN_kernel.cu:336-454, where the
  window's binary/weighted A-tile multiplies gathered neighbor features).
* ``sddmm`` — per-edge score ``e_(i,j) = <X[i], X[j]>`` (matches
  ``sddmm_forward_cuda_kernel``, TCGNN_kernel.cu:584-728).

All run on CPU for tests; they are also the fallback path for graphs too
small to benefit from tiling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def edge_rows_from_csr(row_pointers: jnp.ndarray, num_edges: int) -> jnp.ndarray:
    """Expand CSR indptr into a per-edge row id (reference's ``edgeToRow``,
    TCGNN.cpp:193-197) — jit-friendly via searchsorted."""
    eids = jnp.arange(num_edges, dtype=row_pointers.dtype)
    return jnp.searchsorted(row_pointers[1:], eids, side="right").astype(jnp.int32)


def spmm_ref(
    x: jnp.ndarray,
    row_pointers: jnp.ndarray,
    column_index: jnp.ndarray,
    edge_weights: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Oracle SpMM: ``out = A @ x`` with A given in CSR (optionally weighted)."""
    num_nodes = row_pointers.shape[0] - 1
    num_edges = column_index.shape[0]
    rows = edge_rows_from_csr(row_pointers, num_edges)
    gathered = x[column_index]
    if edge_weights is not None:
        gathered = gathered * edge_weights[:, None]
    return jax.ops.segment_sum(gathered, rows, num_segments=num_nodes)


def sddmm_ref(
    x: jnp.ndarray,
    row_pointers: jnp.ndarray,
    column_index: jnp.ndarray,
) -> jnp.ndarray:
    """Oracle SDDMM: per-edge dot product ``e = <x[row_e], x[col_e]>``."""
    num_edges = column_index.shape[0]
    rows = edge_rows_from_csr(row_pointers, num_edges)
    return jnp.sum(x[rows] * x[column_index], axis=-1)
