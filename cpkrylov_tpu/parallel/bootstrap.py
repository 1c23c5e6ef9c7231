"""Multi-host bootstrap: ``jax.distributed`` initialization + mesh helpers.

The reference has no distributed backend (SURVEY.md §2.4); the equivalent
here is JAX's built-in runtime — ``jax.distributed.initialize`` wires the
processes, and XLA hands the collectives to NCCL, which runs them over
NVLink between the GPUs of one host.  Every GPU reaches every other at the
same rate, so the mesh is a plain 1-D axis shaped by the row partition.

Typical multi-process entry::

    from cpkrylov_tpu.parallel import bootstrap
    bootstrap.initialize("localhost:12355", num_processes=2, process_id=0)
    mesh = bootstrap.make_mesh()           # 1-D "rows" mesh over all GPUs
"""
from __future__ import annotations

import os

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    Pass the coordinator address, the process count and this process's id:
    nothing in a plain GPU or CPU host tells JAX of a cluster.
    """
    import jax

    state = getattr(jax._src.distributed, "global_state", None)
    if state is not None and getattr(state, "client", None) is not None:
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_mesh(axis: str = "rows", devices=None):
    """1-D device mesh over all (global) devices — the row-partition axis."""
    import jax
    from jax.sharding import Mesh

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def local_row_range(n: int, ndev: int, device_index: int) -> tuple[int, int]:
    """Global row interval [r0, r1) owned by ``device_index`` under the
    uniform 1-D row partition used by ``partition.partition_blocks``."""
    n_loc = -(-n // ndev)
    r0 = min(n, device_index * n_loc)
    return r0, min(n, r0 + n_loc)
