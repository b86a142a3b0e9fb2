"""Device meshes for sharded rendering.

The reference has exactly one parallelism strategy — a single-GPU CUDA grid
(SURVEY.md §2, parallelism inventory).  This design scales the same
workload over cards: a 2-D logical mesh whose ``tile`` axis splits pixel
chunks (data parallel over rays; zero communication) and whose ``sample``
axis splits samples-per-pixel (accumulator parallel; one ``psum`` per
chunk).  The cards of a host are joined all to all, so the mesh shape
follows the algorithm only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    sample_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(tile, sample)`` mesh over the first ``n_devices`` devices.

    ``sample_parallel`` devices cooperate on the same pixels (their partial
    sample sums are ``psum``-reduced); the rest split the pixel space.
    """
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    if n_devices % sample_parallel != 0:
        raise ValueError("n_devices must be divisible by sample_parallel")
    grid = np.array(devs[:n_devices]).reshape(
        n_devices // sample_parallel, sample_parallel
    )
    return Mesh(grid, axis_names=("tile", "sample"))


def mesh_shape(mesh: Mesh):
    return mesh.shape["tile"], mesh.shape["sample"]
