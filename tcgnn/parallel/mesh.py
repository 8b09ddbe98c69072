"""Device-mesh helpers for the distributed layer.

Axes:
  * ``graph``   — row-window-aligned node/edge partitioning (the data-parallel
    axis for full-graph GNN training; each device owns a contiguous window
    range, see :mod:`tcgnn.parallel.partition`).
  * ``feature`` — embedding-dimension sharding (tensor-parallel axis; the
    mesh-level generalization of the reference's per-warp dim-tile split,
    ``/root/reference/TCGNN_conv/TCGNN_kernel.cu:355``).

The reference is strictly single-GPU (SURVEY.md §2.3); this layer is the
additive distributed scope.  On one NVLink host every device reaches every
other at the same rate, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_graph: int | None = None, n_feature: int = 1, devices=None) -> Mesh:
    """Build a ('graph', 'feature') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_graph is None:
        n_graph = max(len(devices) // n_feature, 1)
    n = n_graph * n_feature
    if n > len(devices):
        raise ValueError(
            f"mesh {n_graph}x{n_feature} needs {n} devices, have {len(devices)}"
        )
    dev = np.asarray(devices[:n]).reshape(n_graph, n_feature)
    return Mesh(dev, ("graph", "feature"))


def make_mesh_two_level(
    n_hosts: int,
    chips_per_host: int,
    n_feature: int = 1,
    devices=None,
) -> Mesh:
    """('graph', 'feature') mesh for G beyond one host, laid out HOST-MAJOR.

    The graph axis spans ``n_hosts * chips_per_host`` shards with shard
    ``g`` placed on host ``g // chips_per_host``.  Because the partition
    assigns *contiguous* window ranges to consecutive graph indices and
    bandwidth-ordered graphs exchange halo almost exclusively between
    neighboring shards, this placement keeps the bulk of the halo
    all_to_all on intra-host links; only shard pairs straddling a host
    boundary cross hosts (quantify with
    :func:`tcgnn.parallel.comm_stats.dcn_halo_fraction`).

    Axis names and every collective are IDENTICAL to :func:`make_mesh` —
    the hierarchy is pure device placement, so all distributed machinery
    composes unchanged.  ``jax.devices()`` orders devices process-major in
    real multi-host runs, which is exactly the order consumed here.
    """
    if devices is None:
        devices = jax.devices()
    n_graph = n_hosts * chips_per_host
    if n_graph * n_feature > len(devices):
        raise ValueError(
            f"two-level mesh {n_hosts}x{chips_per_host}x{n_feature} needs "
            f"{n_graph * n_feature} devices, have {len(devices)}"
        )
    return make_mesh(n_graph, n_feature, devices)
