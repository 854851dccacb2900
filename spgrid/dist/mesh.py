"""Mesh construction helpers.

The reference pins OpenMP threads to cores (config.sh:16-31 pinning calc);
the device analogue is a named mesh over the cards.  The four cards of one
host reach each other all to all over NVLink, so the mesh follows the
algorithm alone.  Multi-host entry: ``jax.distributed`` init per host,
mesh spanning all processes."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh


def device_mesh_shape(n_devices: int, n_axes: int = 2) -> Tuple[int, ...]:
    """Factor n_devices into a near-square n_axes shape (data-major)."""
    shape = [1] * n_axes
    remaining = n_devices
    for i in range(n_axes - 1, 0, -1):
        f = _largest_factor_le(remaining, int(round(remaining ** (1 / (i + 1)))))
        shape[i] = f
        remaining //= f
    shape[0] = remaining
    return tuple(shape)


def _largest_factor_le(n: int, limit: int) -> int:
    limit = max(1, min(limit, n))
    for f in range(limit, 0, -1):
        if n % f == 0:
            return f
    return 1


def available_devices(n_devices: int):
    """The first n_devices devices of the default backend.

    Virtual CPU devices are used only where the caller asked for them
    (JAX_PLATFORMS=cpu with --xla_force_host_platform_device_count);
    fewer devices than requested is an error, never a quiet move to
    another backend."""
    devices = jax.devices()
    if len(devices) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(devices)} "
            f"{devices[0].platform} device(s); for a CPU rehearsal set "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n_devices}")
    return devices[:n_devices]


def make_mesh(
    axis_names: Sequence[str] = ("data", "model"),
    shape: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = device_mesh_shape(n, len(axis_names))
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, tuple(axis_names))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (one process per host).

    No-op when single-process.  Nothing tells JAX of a cluster, so the
    coordinator address, process count and id are given explicitly."""
    if num_processes is None and coordinator is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def device_topology() -> dict:
    """Device topology snapshot (ref: lib/topology.h core/NUMA discovery —
    here cards, hosts, and device coordinates).

    Returns {platform, num_devices, num_hosts, devices: [{id, process,
    kind, coords, core_on_chip}]}."""
    devs = jax.devices()
    out = []
    for d in devs:
        out.append({
            "id": d.id,
            "process": getattr(d, "process_index", 0),
            "kind": getattr(d, "device_kind", "unknown"),
            "coords": tuple(getattr(d, "coords", ()) or ()),
            "core_on_chip": getattr(d, "core_on_chip", 0),
        })
    return {
        "platform": devs[0].platform if devs else "none",
        "num_devices": len(devs),
        "num_hosts": jax.process_count(),
        "devices": out,
    }
