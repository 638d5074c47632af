"""Multi-host (multi-process) initialization and mesh construction.

The reference is strictly single-device (SURVEY.md section 2.3: one OpenCL
device, zero inter-device communication).  This module is the framework's
scaling entry point: ``jax.distributed.initialize`` across hosts, then a
``(host, view)``-factored device mesh where the view axis maps to the
devices *within* each host (collectives over it stay on the host's
interconnect, NVLink on a four-card machine) and the host axis spans
processes over the network — scene/keyframe granularity work goes on the
host axis, per-view and cost-volume collectives stay within a host,
matching the layout plan of SURVEY.md section 5.
"""

from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize multi-process JAX.

    No-ops when running single-process with no coordinator configured (the
    common single-host case and all tests).  With arguments — or the
    standard ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` env triplet — it brings up the distributed runtime
    so ``jax.devices()`` spans every host.
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and num_processes is None:
        return  # single process
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_host_view_mesh(views_per_host: int | None = None) -> Mesh:
    """Build a ``(host, view)`` mesh over all global devices, keeping each
    host's local devices contiguous on the view axis so view-axis
    collectives never cross hosts."""
    devs = jax.devices()
    n_hosts = max(p.process_index for p in devs) + 1
    per_host = len(devs) // n_hosts
    if views_per_host is None:
        views_per_host = per_host
    if views_per_host != per_host:
        raise ValueError(
            f"views_per_host {views_per_host} != local device count {per_host}"
        )
    ordered = sorted(devs, key=lambda d: (d.process_index, d.id))
    grid = np.asarray(ordered).reshape(n_hosts, per_host)
    return Mesh(grid, axis_names=("host", "view"))
