"""GNN layers: GCN / GIN / AGNN convolutions + the SAG primitive.

Functional (params-as-pytrees) re-design of the reference's
``torch.nn.Module`` layers and autograd functions
(/root/reference/gnn_conv.py:26-247):

* ``gcn_conv``  — ``aggregate(X @ W)``  (TCGNNFunction, gnn_conv.py:52-85)
* ``gin_conv``  — ``aggregate(X) @ W``  (TCGNNFunction_GIN, gnn_conv.py:87-113)
* ``agnn_conv`` — ``X' = X @ W``; per-edge scores via SDDMM; per-head edge
  attention ``att = e ⊗ attention_w``; weighted aggregation
  (TCGNNFunction_AGNN, gnn_conv.py:115-158).  The reference launches one
  kernel per head that all race on the same output buffer
  (TCGNN_kernel.cu:253-268) and runs with n_heads=1 (gnn_conv.py:10); we
  aggregate each head and average, which coincides with the reference for
  one head and is well-defined for more.
* ``sag``      — pure aggregation (TCGNNFunction_SAG, gnn_conv.py:26-49).

All dense GEMMs are XLA matmuls; aggregation rides the SGT ops through
:class:`tcgnn.graph.TiledGraph`.
"""

from __future__ import annotations

import math
from typing import Dict

import jax
import jax.numpy as jnp

from tcgnn.graph import TiledGraph

Params = Dict[str, jnp.ndarray]


# --------------------------------------------------------------------------
# Parameter initialization
# --------------------------------------------------------------------------
def init_linear(key, in_dim: int, out_dim: int, init: str = "reference") -> jnp.ndarray:
    """``reference`` = plain randn like the GPU repo's layers
    (gnn_conv.py:195,215 — reset_parameters is commented out); ``uniform`` =
    the repo's (unused) reset_parameters / AGNN init (gnn_conv.py:198-200)."""
    w = jax.random.normal(key, (in_dim, out_dim), jnp.float32)
    if init == "uniform":
        stdv = 1.0 / math.sqrt(out_dim)
        w = jax.random.uniform(key, (in_dim, out_dim), jnp.float32, -stdv, stdv)
    return w


def init_gcn(key, in_dim: int, out_dim: int, init: str = "reference") -> Params:
    return {"weights": init_linear(key, in_dim, out_dim, init)}


init_gin = init_gcn


def init_agnn(key, in_dim: int, out_dim: int, n_heads: int = 1) -> Params:
    kw, ka = jax.random.split(key)
    stdv = 1.0 / math.sqrt(out_dim)
    return {
        # AGNNConv always uniform-resets (gnn_conv.py:233).
        "weights": jax.random.uniform(kw, (in_dim, out_dim), jnp.float32, -stdv, stdv),
        "attention_w": jax.random.uniform(ka, (1, n_heads), jnp.float32, -stdv, stdv),
    }


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------
def _ct(graph):
    """The graph's compute dtype (f32 configs keep everything f32)."""
    cfg = getattr(graph, "config", None)
    return cfg.compute_dtype if cfg is not None else jnp.float32


def _amp_dot(a, w, ct):
    """Dense update matmul in the compute dtype: f32 accumulate,
    compute-dtype output.  Mixed-precision training keeps activations in
    ``ct`` end to end — a blanket f32 op boundary materialized a convert
    pass before every dense matmul (XLA cannot fuse a convert into a dot
    operand), measurably regressing condensed-path epochs."""
    return jnp.dot(
        a.astype(ct), w.astype(ct), preferred_element_type=jnp.float32
    ).astype(ct)


def gcn_conv(
    params: Params,
    x: jnp.ndarray,
    graph: TiledGraph,
    norm: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """GEMM node update, then SpMM neighbor aggregation (gnn_conv.py:59-68).

    ``norm`` is an optional per-node ``deg^-1/2`` vector: applied before and
    after aggregation it yields symmetric GCN normalization
    ``D^-1/2 A D^-1/2`` — the reference computes these factors but never
    applies them (dataset.py:107-108); its DGL baseline does
    (dgl_baseline/train.py:37-39), so parity runs need the option.
    """
    in_dim, out_dim = params["weights"].shape
    aggregate_first = gcn_aggregates_first(graph, in_dim, out_dim)
    ct = _ct(graph)
    x = x.astype(ct)
    nv = None if norm is None else norm.astype(ct)
    if aggregate_first:
        h = x if nv is None else x * nv[: x.shape[0], None]
        agg = graph.spmm(h)
        if nv is not None:
            agg = agg * nv[: agg.shape[0], None].astype(agg.dtype)
        return _amp_dot(agg, params["weights"], ct)
    x_prime = _amp_dot(x, params["weights"], ct)
    if nv is not None:
        x_prime = x_prime * nv[: x_prime.shape[0], None]
    out = graph.spmm(x_prime)
    if nv is not None:
        out = out * nv[: out.shape[0], None].astype(out.dtype)
    return out


def gcn_aggregates_first(graph, in_dim: int, out_dim: int) -> bool:
    """GCN schedule: ``A(XW) == (AX)W`` exactly (diagonal norms commute
    too), so aggregate at whichever width is cheaper.

    The block-diagonal route has no gather and its cost scales with the
    feature width, so it aggregates at the narrower side (ties prefer
    aggregate-first, gin_conv's schedule).  The condensed routes' cost is
    dominated by per-row gathers up to some width, so they aggregate first
    unless the input is wider than ``max(out, 128)`` (e.g. citeseer's
    3703-dim input still projects first).  The 128 is not measured on the
    H100 (ROADMAP A4).
    """
    if getattr(graph, "block_diag", False):
        return in_dim <= out_dim
    return in_dim <= max(out_dim, 128)


def gin_conv(params: Params, x: jnp.ndarray, graph: TiledGraph) -> jnp.ndarray:
    """SpMM aggregation first, then GEMM update (gnn_conv.py:92-97)."""
    ct = _ct(graph)
    return _amp_dot(graph.spmm(x.astype(ct)), params["weights"], ct)


def agnn_conv(params: Params, x: jnp.ndarray, graph: TiledGraph) -> jnp.ndarray:
    """Projection -> SDDMM edge scores -> per-head attention -> weighted SpMM
    (gnn_conv.py:117-136).

    When the graph offers the fused tile-space aggregation (symmetric +
    dense tiles), the whole scores->attention->weighted-aggregate pipeline
    collapses into it: attention here is ``att_e = c_h * e_e``, so the
    head-averaged output is ``mean(c) * (A ⊙ S) X`` — mathematically
    identical, with no per-edge scatter/gather round trip.
    """
    x_prime = _amp_dot(x, params["weights"], _ct(graph))
    fused = getattr(graph, "agnn_aggregate", None)
    n_heads = params["attention_w"].shape[1]
    if fused is not None:
        # ANY head count: every head's attention is a scalar gate on the
        # same edge score (att_e^h = c_h * e_e), so the head-averaged sum
        # of H weighted aggregations is  mean_h c_h * (A ⊙ S) X  — exactly
        # what the fused kernel computes (graph.agnn_aggregate applies
        # mean(att_w); its backward emits the matching per-head gradient
        # d c_h = <dy, (A⊙S)x>/H).  The H aggregations share one score
        # pass and one gathered operand by construction, so multi-head
        # costs the same single fused fwd+bwd pass as one head.
        return fused(x_prime, params["attention_w"])
    # No fused path (asymmetric / chunked graphs): the reference schedule —
    # per-edge scores once, then one genuinely separate weighted
    # aggregation per head, head-averaged (gnn_conv.py:115-158; the
    # reference's per-head kernel TCGNN_kernel.cu:243-268 races on its
    # shared accumulator — here each head is an independent exact pass).
    edge_feature = graph.sddmm(x_prime)  # [n_e]
    # [n_e, 1] @ [1, n_heads] -> [n_e, n_heads]  (gnn_conv.py:128)
    edge_attentions = edge_feature[:, None] * params["attention_w"]
    out = graph.spmm_weighted(x_prime, edge_attentions[:, 0])
    for h in range(1, n_heads):
        out = out + graph.spmm_weighted(x_prime, edge_attentions[:, h])
    return out / n_heads


def sag(x: jnp.ndarray, graph: TiledGraph) -> jnp.ndarray:
    """Pure scatter-and-gather aggregation (gnn_conv.py:26-49)."""
    return graph.spmm(x)
