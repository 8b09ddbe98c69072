"""Distributed full-graph training step over a ('graph','feature') mesh.

The single-device trainer (:mod:`tcgnn.train`) mirrors the reference's
``main_tcgnn.py``; this module is the multi-device version the reference
never had (SURVEY.md §2.3): node/edge-sharded features and labels,
replicated parameters (XLA inserts the gradient all-reduce), aggregation
through
:class:`tcgnn.parallel.graph.DistributedTiledGraph`'s shard_map ops.

Padding conventions:
  * nodes are padded to ``graph.padded_nodes`` — the NLL loss is masked to
    real nodes (the reference trains on all nodes, ``main_tcgnn.py:149``);
  * hidden/class widths are rounded up to a multiple of the ``feature`` axis
    size; padded logit columns are masked to -inf before log_softmax so the
    loss is exactly the unpadded model's.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from tcgnn.models import nets
from tcgnn.parallel.graph import DistributedTiledGraph


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def init_distributed_net(
    key,
    kind: str,
    in_dim: int,
    hidden: int,
    classes: int,
    num_layers: int,
    graph: DistributedTiledGraph,
    n_heads: int = 1,
):
    """Init params with widths rounded up for even feature-axis sharding.

    Returns (params, padded_hidden, padded_classes).
    """
    pf = graph.pf
    hidden_p = _round_up(hidden, pf)
    classes_p = _round_up(classes, pf)
    params = nets.init_net(
        key, kind, in_dim, hidden_p, classes_p, num_layers, n_heads=n_heads
    )
    return params, hidden_p, classes_p


def make_distributed_train_step(
    graph: DistributedTiledGraph,
    kind: str,
    x: jnp.ndarray,
    y: jnp.ndarray,
    optimizer: optax.GradientTransformation,
    dropout_rate: float = 0.5,
    num_valid_classes: Optional[int] = None,
    norm: Optional[jnp.ndarray] = None,
    hoist: bool = True,
):
    """Jitted full-batch distributed step (forward, masked NLL, Adam).

    ``x`` must be placed with ``graph.shard_features``; ``y`` with
    ``graph.shard_nodes`` (int labels, padded entries arbitrary — masked);
    ``norm`` (optional GCN normalization) with ``graph.shard_nodes`` too
    (padded entries 0, so padded rows stay 0).

    ``hoist`` precomputes the loop-invariant layer-1 aggregate once (one
    distributed spmm incl. its halo exchange) and drops it from every epoch;
    exact for GCN/GIN (``nets.apply_net``), sharded like the features.
    """
    mask = graph.valid_node_mask()
    denom = jnp.asarray(float(graph.num_nodes), jnp.float32)
    garr = graph.arrays()
    l1_agg = (
        nets.hoist_l1_aggregate(kind, x, graph.bind(garr), norm=norm)
        if hoist
        else None
    )

    def loss_fn(params, key, x, y, mask, g, l1_agg):
        logp = nets.apply_net(
            params,
            kind,
            x,
            g,
            dropout_key=key,
            dropout_rate=dropout_rate,
            num_valid_classes=num_valid_classes,
            norm=norm,
            l1_agg=l1_agg,
        )
        # One-hot select, not take_along_axis: the iota-compare mask fuses
        # into the log-softmax pass (see the single-device loss_fn).
        onehot = jnp.arange(logp.shape[1], dtype=y.dtype)[None, :] == y[:, None]
        nll = -jnp.sum(jnp.where(onehot, logp, 0.0), axis=1)
        return jnp.sum(nll * mask) / denom

    # Donated like the single-device step: Adam state + params update in
    # place instead of holding two generations in HBM.
    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def _step(params, opt_state, key, x, y, mask, garr, l1_agg):
        g = graph.bind(garr)
        key, sub = jax.random.split(key)
        loss, grads = jax.value_and_grad(loss_fn)(
            params, sub, x, y, mask, g, l1_agg
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, key, loss

    def step(params, opt_state, key):
        return _step(params, opt_state, key, x, y, mask, garr, l1_agg)

    # Instrumentation hooks (parallel.comm_stats): the underlying jit and
    # its closed-over operands, so the compiled step's HLO can be inspected
    # (measured collective bytes) without re-deriving the argument list.
    step.jitted = _step
    step.bound_args = (x, y, mask, garr, l1_agg)
    return step
