from tcgnn.parallel.mesh import make_mesh, make_mesh_two_level
from tcgnn.parallel.comm_stats import (
    dcn_halo_fraction,
    step_collective_bytes,
)
from tcgnn.parallel.partition import partition_csr, partition_graph, ShardedSGTMeta
from tcgnn.parallel.graph import (
    DistributedTiledGraph,
    distributed_graph_from_dataset,
    probe_block_diag,
)
from tcgnn.parallel.train import (
    init_distributed_net,
    make_distributed_train_step,
)

__all__ = [
    "make_mesh",
    "make_mesh_two_level",
    "dcn_halo_fraction",
    "step_collective_bytes",
    "partition_csr",
    "partition_graph",
    "ShardedSGTMeta",
    "DistributedTiledGraph",
    "distributed_graph_from_dataset",
    "probe_block_diag",
    "init_distributed_net",
    "make_distributed_train_step",
]
