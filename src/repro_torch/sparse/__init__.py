from .csr import CSR
from .partition import (
    PartitionedCSR,
    block_offsets,
    distributed_spmv_numpy,
    partition_csr,
    partition_rect_csr,
    partitioned_from_blocks,
    split_rows,
    stack_blocks,
)
from .device import (
    DeviceEll,
    DeviceEllBlocked,
    KernelSelection,
    OverlapSelection,
    distributed_spmv,
    make_distributed_spmv,
    overlap_decision,
    pack_vector,
    partitioned_to_device,
    partitioned_to_ell,
    partitioned_to_ell_blocked,
    row_block_bucket_map,
    select_spmv_kernel,
    select_spmv_overlap,
    spmv_blocked_vmem_bytes,
    spmv_flat_vmem_bytes,
    unpack_vector,
)
from .spgemm import (
    RapResult,
    RowGather,
    gather_remote_rows,
    merge_row_sets,
    spgemm_local,
    spgemm_rap,
)

__all__ = [
    "CSR", "PartitionedCSR", "block_offsets", "distributed_spmv_numpy",
    "partition_csr", "partition_rect_csr", "partitioned_from_blocks",
    "split_rows", "stack_blocks",
    "DeviceEll", "DeviceEllBlocked", "KernelSelection", "OverlapSelection",
    "distributed_spmv", "make_distributed_spmv", "overlap_decision", "pack_vector",
    "partitioned_to_device", "partitioned_to_ell",
    "partitioned_to_ell_blocked", "row_block_bucket_map",
    "select_spmv_kernel", "select_spmv_overlap",
    "spmv_blocked_vmem_bytes", "spmv_flat_vmem_bytes", "unpack_vector",
    "RapResult", "RowGather", "gather_remote_rows", "merge_row_sets",
    "spgemm_local", "spgemm_rap",
]
