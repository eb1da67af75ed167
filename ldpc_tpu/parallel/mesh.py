"""Device mesh construction and batch sharding (SURVEY.md §2.3, §3.5).

The reference is a single-process sequential simulator; its outer Monte-Carlo
loop becomes the data-parallel axis here: the codeword batch is sharded over
every device of a jax.sharding.Mesh, XLA inserts the psum for the error
counters, and only O(1) scalars cross devices per superbatch (BASELINE.json:5 'codeword
batch ... sharded over chips', 'early-termination syndrome checks via
all-reduce').

Mesh axis convention: a single flat ("batch",) axis on one host — the cards of
a host are joined all to all, so the mesh follows the algorithm alone — or
("host", "device") across hosts. The batch dimension of every tensor is sharded
over ALL mesh axes; everything else is replicated.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axes: Tuple[str, ...] = ("batch",),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a Mesh over the available devices.

    shape=None uses all devices on one flat axis. For multi-host runs pass
    shape=(n_hosts, devices_per_host) with axes=("host", "device")
    (SURVEY.md §2.4).
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devs),)
        axes = axes[:1]
    if math.prod(shape) != len(devs):
        raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
    return Mesh(devs.reshape(shape), axes)


def batch_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Sharding with the leading (batch) dim split over all mesh axes."""
    return NamedSharding(mesh, P(mesh.axis_names, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_multiple(mesh: Mesh, batch_tile: int = 1) -> int:
    """Global batch sizes must divide evenly: n_devices * batch_tile."""
    return mesh.size * batch_tile


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Multi-host bootstrap (SURVEY.md §3.5). Call before any jax op.

    On a single host this is unnecessary; sweeps call it only when configured
    with num_processes > 1 (sim/sweep.py).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
