"""Mesh helpers.

The reference is single-process with no communication backend (SURVEY.md
§2.12-bis); scale-out here is jax.sharding over ICI/DCN: landmark shards for
bundle adjustment ('lm' axis) and independent sequences for data parallelism
('seq' axis). Collectives are XLA psum/all_gather inserted via shard_map —
no hand-written backend.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> int:
    """Multi-host entry point: jax.distributed.initialize from args or env.

    The reference has no communication backend at all (SURVEY.md §2.12-bis;
    vcpkg.json lists no MPI/NCCL); multi-host runs here ride JAX's built-in
    distributed runtime. Call this ONCE per process before any backend use,
    then `jax.devices()` is the GLOBAL device list and make_mesh() builds
    meshes over every host's devices.

    Configuration precedence: explicit args > SLAM_COORDINATOR /
    SLAM_NUM_PROCESSES / SLAM_PROCESS_ID env vars > cluster auto-detection
    (SLURM/GKE, handled inside jax.distributed.initialize) > single-process
    no-op. Returns the process count.
    """
    coordinator_address = coordinator_address or os.environ.get("SLAM_COORDINATOR")
    if num_processes is None and "SLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SLAM_NUM_PROCESSES"])
    if process_id is None and "SLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SLAM_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return 1  # single process: nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count()


def make_mesh(shape: dict[str, int] | None = None) -> Mesh:
    """Build a mesh from {axis: size} over the GLOBAL device list (all hosts
    after initialize_distributed); default: all devices on 'lm'."""
    devices = np.asarray(jax.devices())
    if shape is None:
        shape = {"lm": len(devices)}
    sizes = tuple(shape.values())
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(
            f"mesh {shape} needs {np.prod(sizes)} devices, have {len(devices)}"
        )
    return Mesh(devices.reshape(sizes), tuple(shape.keys()))


def put_sharded(x, sharding: NamedSharding):
    """Place a host array onto a (possibly multi-host) sharding.

    Single-process: plain device_put. Multi-process: `x` holds only this
    process's rows of the global array (each host decodes only its own
    sequences' frames) and is assembled via
    jax.make_array_from_process_local_data — no cross-host gather of pixel
    data ever happens.
    """
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    return jax.make_array_from_process_local_data(sharding, np.asarray(x))
