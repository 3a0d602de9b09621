"""Device-mesh helpers.

The reference selects at most one CUDA device (GPU/OpticalFlow.cpp:132-155,
GPU/StitchTool.cpp:33-56); the counterpart here is a jax.sharding Mesh
over all local devices, with multi-host initialisation
via jax.distributed.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

ROW_AXIS = "y"


def make_mesh(n_devices: int | None = None, axis: str = ROW_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def maybe_init_distributed() -> None:
    """Multi-host bring-up (jax.distributed.initialize) when the standard
    coordinator env vars are present; no-op on a single host.

    On auto-detectable clusters (e.g. SLURM) jax infers the process
    count/index itself; on generic clusters pass JAX_NUM_PROCESSES and
    JAX_PROCESS_ID alongside JAX_COORDINATOR_ADDRESS
    (tools/multiprocess_demo.py drives this path with two local
    processes and CPU devices)."""
    import os

    if not os.environ.get("JAX_COORDINATOR_ADDRESS"):
        return
    kw = {}
    if os.environ.get("JAX_NUM_PROCESSES"):
        kw["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
    if os.environ.get("JAX_PROCESS_ID"):
        kw["process_id"] = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(**kw)
