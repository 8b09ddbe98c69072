"""GNN message-passing framework on SGT tiles (TC-GNN capabilities, rebuilt).

A JAX re-design of the TC-GNN system (YukeWang96/TC-GNN_ATC23): Sparse Graph
Translation condenses CSR adjacency into dense tiles, consumed by
tensor-core SpMM / SDDMM ops, with GCN / GIN / AGNN models, a full-graph
trainer, benchmark harness, and a shard_map-based multi-device distribution
layer the reference never had.
"""

import os as _os

import jax as _jax


def compile_cache_dir(environ=_os.environ) -> str:
    """Where the persistent XLA compilation cache lives.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the only cache: JAX reads it
    itself and nothing here overrides it.  Otherwise the cache sits at one
    fixed path inside the checkout (``.cache/jax``, ignored by git), so
    runs of the same checkout find each other's compilations — a path
    that moves would never hit.
    """
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".cache", "jax")


if (
    not _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    and _jax.config.jax_compilation_cache_dir is None
):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from tcgnn.config import DEFAULT_CONFIG, GPU_REFERENCE_CONFIG, TileConfig
from tcgnn.graph import TiledGraph, tiled_graph_from_dataset

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "GPU_REFERENCE_CONFIG",
    "TileConfig",
    "TiledGraph",
    "tiled_graph_from_dataset",
]
