"""Device-mesh helpers for data-parallel (cell-sharded) execution.

The reference's only parallelism is a fork-based process pool over cell
chunks (reference: tl/_infercnv.py:120-135).  Here the equivalent is a 1-D
``jax.sharding.Mesh`` over the cell axis: expression rows are sharded,
the genome plan / reference baseline are replicated, and cluster statistics
reduce with XLA collectives.  The mesh follows the algorithm alone: the cards
of one host reach each other all to all, so no axis mirrors a topology.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["cell_mesh", "shard_cells", "replicate", "mesh_key", "pad_rows"]

CELL_AXIS = "cells"


def mesh_key(mesh: "Mesh") -> tuple:
    """Hashable identity of a mesh — the cache key every sharded-transform
    builder uses (same devices + axis names => same compiled program)."""
    return (tuple(d.id for d in mesh.devices.flat), mesh.axis_names)


def pad_rows(a: np.ndarray, mult: int) -> np.ndarray:
    """Zero-pad the leading axis to a multiple of ``mult`` (no-op if aligned)."""
    pad = (-a.shape[0]) % mult
    if pad:
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)
    return a


def cell_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'cells'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (CELL_AXIS,))


def shard_cells(mesh: Mesh) -> NamedSharding:
    """Sharding that splits the leading (cell) axis across the mesh."""
    return NamedSharding(mesh, P(CELL_AXIS))


def replicate(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding (genome plan, reference baseline, weights)."""
    return NamedSharding(mesh, P())
