"""Multi-host execution: jax.distributed runtime + per-host shard streaming.

The reference's only parallelism is a single-machine process pool
(reference: tl/_infercnv.py:120-135).  The equivalent across hosts:

* ``initialize()`` wraps :func:`jax.distributed.initialize` (no-op when
  single-process);
* every host holds its own horizontal slice of the cell axis (e.g. its shard
  of a distributed AnnData store) and packs it locally
  (:func:`infercnvpy_tpu.ops.infercnv_kernel.pack_csr` — column remap, no
  gather);
* the genome plan, reference baseline and pyramid weights are replicated;
* ``infercnv_global_array`` builds one global jax.Array from the per-host
  shards via :func:`jax.make_array_from_process_local_data` and runs the
  pipeline under a global 1-D cell mesh — the chunk-scoped noise std and
  any cluster statistics become cross-host collectives inserted by XLA.

Chunk semantics stay GLOBAL: ``chunk_ids`` are derived from global cell
indices, so an N-host run reproduces the single-host result exactly (tested
on the virtual 8-device CPU mesh in tests/test_parallel.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["initialize", "global_cell_mesh", "infercnv_global_array"]


def initialize(coordinator_address: str | None = None, num_processes: int | None = None, process_id: int | None = None):
    """Start the jax.distributed runtime (no-op if already initialized or single-process)."""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized


def global_cell_mesh():
    """1-D mesh over ALL devices of ALL processes, axis 'cells'."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), ("cells",))


def infercnv_global_array(local_packed: np.ndarray, mesh=None):
    """Assemble a global cell-sharded jax.Array from this host's packed rows.

    ``local_packed`` is this process's horizontal slice (local_cells × packed
    width), in process order.  Returns a global array sharded over the 'cells'
    mesh axis; feed it to a :func:`sharded_infercnv_fn` transform.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    if mesh is None:
        mesh = global_cell_mesh()
    sharding = NamedSharding(mesh, P("cells"))
    if jax.process_count() == 1:
        return jax.device_put(local_packed, sharding)
    return jax.make_array_from_process_local_data(sharding, local_packed)
