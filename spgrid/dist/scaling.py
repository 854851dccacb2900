"""Weak/strong scaling harness over mesh sizes.

BASELINE.json mandates nnz/s scaling efficiency measured at 1 chip, 1 host,
and N>=2 hosts with >=80% weak-scaling at 2+ hosts.  This harness runs the
row-partitioned SpMM over increasing mesh sizes and reports efficiency
relative to the single-device run; on a development box it runs on virtual
CPU devices, on a GPU host it spans its cards (same code path —
jax.distributed + Mesh over all processes).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from spgrid.core.timing import time_kernel_chained
from spgrid.dist.mesh import make_mesh, available_devices
from spgrid.dist.partition import partition_bsr, partition_bsr_halo
from spgrid.dist.spmm import make_dist_spmm
from spgrid.formats.csr import CSRMatrix


@dataclasses.dataclass
class ScalingPoint:
    num_devices: int
    m: int
    nnz: int
    time_s: float
    nnz_per_s: float
    gflops: float
    efficiency: float      # vs the 1-device point (weak: per-device rate)
    comm_bytes: int = 0    # analytic X bytes received per device per step
    device_kind: str = ""  # jax device_kind; CPU devices are marked
                           # 'cpu_virtual (correctness-only)'


def scaling_study(
    matrix_for: Callable[[int], CSRMatrix],
    device_counts: Sequence[int] = (1, 2, 4, 8),
    n: int = 512,
    mode: str = "weak",              # 'weak' | 'strong'
    x_partition: str = "replicated",
    use_pallas: bool = False,
    dtype: str = "float32",
    min_time_s: float = 0.3,
    seed: int = 14,
) -> List[ScalingPoint]:
    """Run the distributed SpMM at each device count.

    ``matrix_for(d)`` returns the matrix for a d-device run — for weak
    scaling it should grow rows ~proportionally to d; for strong scaling
    return the same matrix for every d.
    """
    points: List[ScalingPoint] = []
    if not device_counts:
        return points
    base_rate = None
    # One backend for every point: mixing the real chip for d=1 with
    # virtual CPU devices for d>1 would make efficiencies meaningless.
    pool = available_devices(max(device_counts))
    for d in device_counts:
        devices = pool[:d]
        if d > len(devices):
            break
        csr = matrix_for(d).astype(np.dtype(dtype))
        mesh = make_mesh(("data", "model"), shape=(1, d), devices=devices)
        if x_partition == "halo":
            sharded = partition_bsr_halo(csr, d, bm=8, bk=128)
        else:
            sharded = partition_bsr(csr, d, bm=8, bk=128)
        fn = make_dist_spmm(mesh, sharded, x_partition=x_partition,
                            use_pallas=use_pallas, data_axis="data")
        rng = np.random.default_rng(seed)
        x = jnp.asarray((rng.random((csr.k, n)) + 0.5).astype(dtype))
        x = jax.device_put(x, NamedSharding(mesh, P(None, "data")))
        timed = time_kernel_chained(lambda xc: fn(xc), x,
                                    min_time_s=min_time_s)
        nnz_rate = csr.nnz / timed.time_per_iter_s
        itemsize = np.dtype(dtype).itemsize
        # analytic communication volume per device per step: the halo
        # exchange moves only neighbor shards (O(halo)); the all-gather
        # alternative moves (d-1)/d of X.  Time on virtual CPU devices
        # cannot prove the advantage (one physical core under the mesh),
        # so there the byte accounting carries the claim.
        if d == 1 or x_partition == "replicated":
            comm = 0
        elif x_partition == "halo":
            halo_shards = (getattr(sharded, "halo_left", 0)
                           + getattr(sharded, "halo_right", 0))
            comm = halo_shards * (csr.k // d) * n * itemsize
        else:
            comm = (d - 1) * (csr.k // d) * n * itemsize
        kind = devices[0].device_kind
        if devices[0].platform == "cpu":
            kind = "cpu_virtual (correctness-only)"
        if mode == "weak":
            rate_per_dev = nnz_rate / d
            if base_rate is None:
                base_rate = rate_per_dev
            eff = rate_per_dev / base_rate
        else:
            if base_rate is None:
                base_rate = nnz_rate
            eff = nnz_rate / (base_rate * d)
        points.append(ScalingPoint(
            num_devices=d, m=csr.m, nnz=csr.nnz,
            time_s=timed.time_per_iter_s,
            nnz_per_s=nnz_rate,
            gflops=2.0 * csr.nnz * n / timed.time_per_iter_s / 1e9,
            efficiency=eff,
            comm_bytes=comm,
            device_kind=kind,
        ))
    return points
