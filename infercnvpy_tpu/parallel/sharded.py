"""Cell-sharded infercnv pipeline via shard_map over the 'cells' mesh axis.

The transform from :mod:`infercnvpy_tpu.ops.infercnv_kernel` is pure
data-parallel over cells except for the chunk-scoped noise std; under
``shard_map`` each shard computes partial per-chunk sums over the GLOBAL
chunk ids and the partials are combined with ``psum`` — the counterpart of
the reference's vstack-gather (reference: tl/_infercnv.py:137).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import PartitionSpec as P

from ..genome.plan import WindowPlan
from ..ops.infercnv_kernel import build_infercnv_fn
from .mesh import CELL_AXIS, cell_mesh, replicate, shard_cells

__all__ = ["sharded_infercnv_fn", "run_sharded_infercnv"]


#: memoized shard-mapped transforms (fresh jit objects would recompile per call)
_BUILD_CACHE: dict = {}


class _ShardedFn:
    """Callable with the ``(x_res, gene_res)`` contract plus AOT hooks.

    ``jitted`` is the underlying jit object (lowerable for ahead-of-time
    compilation); ``wrap_out`` maps its raw output back to the public
    two-tuple contract.  The driver's executable cache uses both.
    """

    def __init__(self, jitted, wrap_out):
        self.jitted = jitted
        self.wrap_out = wrap_out

    def __call__(self, x, ref, chunk_ids):
        return self.wrap_out(self.jitted(x, ref, chunk_ids))


def _wrap_pair(out):
    return out


def _wrap_single(out):
    return out, None


def sharded_infercnv_fn(
    plan: WindowPlan,
    mesh=None,
    *,
    n_ref_rows: int,
    lfc_clip: float = 3.0,
    dynamic_threshold: float | None = 1.5,
    num_chunks: int = 1,
    calculate_gene_values: bool = False,
    dtype=None,
):
    """Build the infercnv transform shard-mapped over the cell axis.

    Returns ``fn(x, ref, chunk_ids) -> (x_res, gene_res)``; the cell axis of
    ``x``/``chunk_ids`` must be divisible by the mesh size.
    """
    import jax.numpy as jnp

    if mesh is None:
        mesh = cell_mesh()
    if dtype is None:
        dtype = jnp.float32

    from .mesh import mesh_key

    key = (
        plan.cache_key, *mesh_key(mesh),
        n_ref_rows, float(lfc_clip),
        None if dynamic_threshold is None else float(dynamic_threshold),
        num_chunks, calculate_gene_values, str(jnp.dtype(dtype)),
    )
    cached = _BUILD_CACHE.get(key)
    if cached is not None:
        return cached

    base = build_infercnv_fn(
        plan,
        n_ref_rows=n_ref_rows,
        lfc_clip=lfc_clip,
        dynamic_threshold=dynamic_threshold,
        num_chunks=num_chunks,
        calculate_gene_values=calculate_gene_values,
        dtype=dtype,
        axis_name=CELL_AXIS,
    )
    in_specs = (P(CELL_AXIS), P(), P(CELL_AXIS))
    if calculate_gene_values:
        mapped = jax.shard_map(base, mesh=mesh, in_specs=in_specs, out_specs=(P(CELL_AXIS), P(CELL_AXIS)))
        fn = _ShardedFn(jax.jit(mapped), _wrap_pair)
    else:
        mapped = jax.shard_map(
            lambda x, ref, cid: base(x, ref, cid)[0], mesh=mesh, in_specs=in_specs, out_specs=P(CELL_AXIS)
        )
        fn = _ShardedFn(jax.jit(mapped), _wrap_single)

    _BUILD_CACHE[key] = fn
    return fn


def run_sharded_infercnv(fn, mesh, x: np.ndarray, ref: np.ndarray, chunk_ids: np.ndarray, n_devices=None):
    """Pad the cell axis to the mesh size, place the operands, and run."""
    n_dev = n_devices or mesh.devices.size
    n = x.shape[0]
    pad = (-n) % n_dev
    if pad:
        x = np.concatenate([x, np.zeros((pad, x.shape[1]), x.dtype)], axis=0)
        chunk_ids = np.concatenate([chunk_ids, np.full(pad, chunk_ids.max() + 1, chunk_ids.dtype)])
    data = shard_cells(mesh)
    repl = replicate(mesh)
    x_res, gene_res = fn(
        jax.device_put(x, data), jax.device_put(ref, repl), jax.device_put(np.asarray(chunk_ids), data)
    )
    x_res = np.asarray(x_res)[:n]
    gene_res = None if gene_res is None else np.asarray(gene_res)[:n]
    return x_res, gene_res
