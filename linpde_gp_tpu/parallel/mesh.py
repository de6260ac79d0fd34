"""Device-mesh helpers.

The reference is single-process (SURVEY.md L7: "no scheduler, no
communication layer"); scale-out here follows the north-star design:
GSPMD/``shard_map`` over a ``jax.sharding.Mesh``, with mesh axes
``("rows", "cols")`` for Gram/Cholesky work and ``("points",)`` for
embarrassingly parallel posterior evaluation.  Collectives are XLA's
(``psum``/``all_gather`` under ``shard_map``, NCCL on GPUs); the cards of
one host reach each other all to all, so the mesh shape follows the
algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_names=("rows", "cols")):
    """2-D mesh over the first ``n_devices`` devices, as square as
    possible (rows-major)."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    rows = int(np.floor(np.sqrt(n_devices)))
    while n_devices % rows:
        rows -= 1
    cols = n_devices // rows
    mesh_devices = np.asarray(devices).reshape(rows, cols)
    return Mesh(mesh_devices, axis_names)


def make_1d_mesh(n_devices: int | None = None, axis_name: str = "shards"):
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    return Mesh(np.asarray(devices[:n_devices]), (axis_name,))


def row_sharding(mesh: Mesh):
    """Shard the leading axis over ALL mesh axes (rows*cols devices)."""
    return NamedSharding(mesh, P(mesh.axis_names))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
