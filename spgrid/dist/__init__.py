"""Distribution layer: mesh setup + row-partitioned sparse ops over cards.

The one genuinely new capability vs the reference (SURVEY §2.8/§5: the
reference is single-node shared-memory; multi-node = independent Slurm
jobs).  Here: ``jax.sharding.Mesh`` over cards, nnz-balanced row
partitioning of the sparse operand (the device analogue of
``loop_partitioner_balance_prefix_sums``), and ``shard_map`` kernels whose
dense-operand exchange rides XLA collectives (NCCL over NVLink on a GPU
host).
"""

from spgrid.dist.mesh import make_mesh, device_mesh_shape, \
    available_devices, device_topology
from spgrid.dist.partition import ShardedBSR, partition_bsr, \
    partition_bsr_halo
from spgrid.dist.spmm import dist_bsr_spmm, make_dist_spmm
from spgrid.dist.attention import DistSparseAttention, make_dist_pipeline_step

__all__ = [
    "make_mesh", "device_mesh_shape", "available_devices",
    "device_topology",
    "ShardedBSR", "partition_bsr", "partition_bsr_halo",
    "dist_bsr_spmm", "make_dist_spmm",
    "DistSparseAttention", "make_dist_pipeline_step",
]

from spgrid.dist.scaling import ScalingPoint, scaling_study  # noqa: E402

__all__ += ["ScalingPoint", "scaling_study"]
