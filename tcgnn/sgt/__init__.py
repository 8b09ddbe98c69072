from tcgnn.sgt.translate import (
    JaxSGTMeta,
    SGTMeta,
    build_a_tiles_host,
    count_blocks,
    sparse_graph_translate,
    transpose_csr,
)
from tcgnn.sgt.reorder import rcm_permutation, reorder_dataset

__all__ = [
    "JaxSGTMeta", "SGTMeta", "build_a_tiles_host", "count_blocks",
    "sparse_graph_translate", "transpose_csr",
    "rcm_permutation", "reorder_dataset",
]
