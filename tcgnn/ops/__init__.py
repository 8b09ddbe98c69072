from tcgnn.ops.spmm import build_a_tiles, spmm_tc, spmm_tc_dense
from tcgnn.ops.sddmm import sddmm_tc, sddmm_tc_dense
from tcgnn.ops.reference import spmm_ref, sddmm_ref

__all__ = [
    "build_a_tiles", "spmm_tc", "spmm_tc_dense",
    "sddmm_tc", "sddmm_tc_dense", "spmm_ref", "sddmm_ref",
]
