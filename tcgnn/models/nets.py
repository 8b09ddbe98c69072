"""Model stacks mirroring the reference trainer's inline ``Net`` classes.

The reference builds, per ``--model``, a stack of identical conv layers with
ReLU + dropout after the first layer and a ``log_softmax`` head
(/root/reference/main_tcgnn.py:75-139).  Structure (for L = num_layers):

    conv_in(features -> hidden) -> relu -> dropout
    (L-2) x [conv(hidden -> hidden) -> relu]
    conv_out(hidden -> classes) -> log_softmax

Functional form: ``init_net`` builds the params pytree, ``apply_net`` runs
the forward pass (dropout active only when a PRNG key is given, matching
``F.dropout(training=...)``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp

from tcgnn.graph import TiledGraph
from tcgnn.models import layers as L

MODEL_KINDS = ("gcn", "gin", "agnn")


def init_net(
    key: jax.Array,
    kind: str,
    in_dim: int,
    hidden: int,
    classes: int,
    num_layers: int,
    n_heads: int = 1,
    init: str = "reference",
) -> List[Dict[str, jnp.ndarray]]:
    if kind not in MODEL_KINDS:
        raise ValueError(f"model must be one of {MODEL_KINDS}, got {kind!r}")
    dims = [in_dim] + [hidden] * max(num_layers - 1, 0)
    dims = dims[:num_layers] + [classes]
    keys = jax.random.split(key, len(dims) - 1)
    params = []
    for k, d_in, d_out in zip(keys, dims[:-1], dims[1:]):
        if kind == "agnn":
            params.append(L.init_agnn(k, d_in, d_out, n_heads))
        else:
            params.append(L.init_gcn(k, d_in, d_out, init))
    return params


def hoist_l1_aggregate(kind: str, x, graph, norm=None):
    """Precompute the loop-invariant layer-1 aggregate ``A X`` (or its
    normalized form ``norm ⊙ A (norm ⊙ X)``) for GCN/GIN; None for models
    whose first aggregation depends on parameters (AGNN attention).

    See ``apply_net``'s ``l1_agg`` docstring for the exactness argument.
    """
    if kind not in ("gcn", "gin"):
        return None
    ct = L._ct(graph)
    x = x.astype(ct)
    use_norm = kind == "gcn" and norm is not None  # norm is a GCN notion
    h = x * norm[: x.shape[0], None].astype(ct) if use_norm else x
    agg = graph.spmm(h)
    if use_norm:
        agg = agg * norm[: agg.shape[0], None].astype(agg.dtype)
    return agg


def apply_net(
    params: List[Dict[str, jnp.ndarray]],
    kind: str,
    x: jnp.ndarray,
    graph: TiledGraph,
    dropout_key: Optional[jax.Array] = None,
    dropout_rate: float = 0.5,
    num_valid_classes: Optional[int] = None,
    norm: Optional[jnp.ndarray] = None,
    l1_agg: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Forward pass.  ``num_valid_classes`` masks trailing logit columns to
    -inf before the log_softmax — used by the distributed trainer when the
    class dim is padded up for even feature-axis sharding.  ``norm`` enables
    symmetric GCN normalization (see ``layers.gcn_conv``).

    ``l1_agg`` is the hoisted layer-1 aggregate (``hoist_l1_aggregate``):
    full-batch training over constant input features makes the first
    aggregation loop-invariant — GCN's ``A(XW) == (AX)W`` and GIN's
    ``(AX)W`` both factor through ``A X``, and dropout sits *after* layer 1
    (reference parity, main_tcgnn.py:91), so hoisting it out of the epoch
    loop is exact: identical activations, losses, and gradients
    (``dW1 = (AX)^T dH`` reuses the same cached aggregate).  The reference
    recomputes this spmm every epoch; this is the training-loop analogue of
    loop-invariant code motion."""
    conv = {"gcn": L.gcn_conv, "gin": L.gin_conv, "agnn": L.agnn_conv}[kind]
    if kind == "gcn" and norm is not None:
        conv = functools.partial(L.gcn_conv, norm=norm)

    if l1_agg is not None and kind in ("gcn", "gin"):
        h = jax.nn.relu(
            L._amp_dot(l1_agg, params[0]["weights"], L._ct(graph))
        )
    else:
        h = jax.nn.relu(conv(params[0], x, graph))
    if dropout_key is not None:
        keep = 1.0 - dropout_rate
        mask = jax.random.bernoulli(dropout_key, keep, h.shape)
        # Scale via a dtype-matched multiply: aggregates arrive in the
        # compute dtype (the kernels store bf16 under bf16 configs).
        h = jnp.where(mask, h * jnp.asarray(1.0 / keep, h.dtype), 0.0)
    for p in params[1:-1]:
        h = jax.nn.relu(conv(p, h, graph))
    h = conv(params[-1], h, graph)
    if num_valid_classes is not None and num_valid_classes < h.shape[1]:
        col = jnp.arange(h.shape[1])[None, :]
        h = jnp.where(col < num_valid_classes, h, -1e30)
    # Loss math in f32 regardless of the compute dtype: log-softmax over
    # bf16 logits costs real precision on the NLL, and the cast fuses into
    # this op (no extra HBM pass).
    return jax.nn.log_softmax(h.astype(jnp.float32), axis=1)
