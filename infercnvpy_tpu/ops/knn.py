"""Exact k-nearest-neighbors via tiled matmuls + running top-k merge.

Replaces the reference's pynndescent/numba approximate kNN (reference:
pp/__init__.py:43 via scanpy).  On an accelerator, brute-force exact kNN is a
natural fit: squared distances are one matmul per (query block × database block) tile,
and a running top-k merge keeps memory at O(block² ) regardless of cell count.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["exact_knn"]


def _query_block_knn_impl(q, qn, qidx, db, dbn, dbidx, k):
    """Top-k nearest DB points for one query block, scanning DB blocks.

    q:   (Bq, d)      query block
    db:  (nb, Bd, d)  database blocks (padded)
    dbn: (nb, Bd)     database squared norms (+inf on padding)
    dbidx: (nb, Bd)   global indices of database points (-1 on padding)
    """

    def scan_body(carry, xs):
        best_d, best_i = carry
        blk, blkn, blki = xs
        # full f32 precision: TF32 distances would reorder near neighbours
        d2 = qn[:, None] + blkn[None, :] - 2.0 * jnp.matmul(q, blk.T, precision=jax.lax.Precision.HIGHEST)
        # exact-zero self distance so the query point always ranks first
        d2 = jnp.where(blki[None, :] == qidx[:, None], -1.0, d2)
        cat_d = jnp.concatenate([best_d, d2], axis=1)
        cat_i = jnp.concatenate([best_i, jnp.broadcast_to(blki[None, :], d2.shape)], axis=1)
        neg_top, top_pos = jax.lax.top_k(-cat_d, k)
        return (-neg_top, jnp.take_along_axis(cat_i, top_pos, axis=1)), None

    # derive the init carry from the query operands (not fresh constants) so
    # it inherits their varying-manual-axes type under shard_map; identical
    # values either way, and XLA folds the arithmetic
    init_d = jnp.broadcast_to(q[:, :1] * 0 + jnp.asarray(jnp.inf, q.dtype), (q.shape[0], k))
    init_i = jnp.broadcast_to((qidx * 0 - 1)[:, None], (q.shape[0], k)).astype(jnp.int32)
    (best_d, best_i), _ = jax.lax.scan(scan_body, (init_d, init_i), (db, dbn, dbidx))
    return jnp.sqrt(jnp.maximum(best_d, 0.0)), best_i


_query_block_knn = partial(jax.jit, static_argnames=("k",))(_query_block_knn_impl)

_SHARDED_CACHE: dict = {}


def _sharded_query_fn(mesh, k: int):
    """shard_map'd query step: queries row-sharded, database replicated.

    The distributed kNN of SURVEY §2.4 / BASELINE configs 4-5: each device
    scans the full (replicated) database for ITS query shard — no collective
    is needed because top-k per query row is embarrassingly parallel over
    queries; results gather back row-sharded.
    """
    from ..parallel.mesh import mesh_key

    key = (*mesh_key(mesh), int(k))
    if key not in _SHARDED_CACHE:
        from jax.sharding import PartitionSpec as P

        from ..parallel.mesh import CELL_AXIS

        C = P(CELL_AXIS)
        mapped = jax.shard_map(
            lambda q, qn, qidx, db, dbn, dbidx: _query_block_knn_impl(q, qn, qidx, db, dbn, dbidx, k),
            mesh=mesh,
            in_specs=(C, C, C, P(), P(), P()),
            out_specs=(C, C),
        )
        _SHARDED_CACHE[key] = jax.jit(mapped)
    return _SHARDED_CACHE[key]


def exact_knn(X: np.ndarray, k: int, *, block: int = 4096, mesh=None):
    """Exact Euclidean kNN (self included as the first neighbor).

    Returns ``(distances, indices)`` of shape (n, k); row i starts with i
    itself at distance 0 — the layout scanpy's neighbor stack expects.

    mesh
        1-D ``jax.sharding.Mesh`` over the cell axis: each host-side query
        block is sharded across the mesh and every device scans the
        replicated database for its shard.  Results are bitwise identical to
        the single-device path (same distances kernel per query row).
    """
    X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
    n, d = X.shape
    k = int(min(k, n))
    n_dev = int(mesh.devices.size) if mesh is not None else 1
    use_mesh = mesh is not None and n_dev > 1

    n_db_blocks = -(-n // block)
    pad_n = n_db_blocks * block
    Xp = np.zeros((pad_n, d), dtype=np.float32)
    Xp[:n] = X
    norms = np.full(pad_n, np.inf, dtype=np.float32)
    norms[:n] = (X * X).sum(axis=1)
    gidx = np.full(pad_n, -1, dtype=np.int32)
    gidx[:n] = np.arange(n, dtype=np.int32)

    db_np = Xp.reshape(n_db_blocks, block, d)
    dbn_np = norms.reshape(n_db_blocks, block)
    dbidx_np = gidx.reshape(n_db_blocks, block)

    dists = np.empty((pad_n, k), dtype=np.float32)
    idxs = np.empty((pad_n, k), dtype=np.int32)
    if use_mesh:
        from ..parallel.mesh import replicate, shard_cells

        data_sh, repl_sh = shard_cells(mesh), replicate(mesh)
        db = jax.device_put(db_np, repl_sh)
        dbn = jax.device_put(dbn_np, repl_sh)
        dbidx = jax.device_put(dbidx_np, repl_sh)
        fn = _sharded_query_fn(mesh, k)
        super_block = block * n_dev
        for start in range(0, pad_n, super_block):
            stop = min(start + super_block, pad_n)
            rows = stop - start
            # multi-superblock inputs pad the trailing block to a FULL
            # super_block (a smaller last block would change the per-device
            # query shape and trigger a second XLA compile); a single-block
            # input pads only to the mesh size — there is no second compile
            # to save and full padding would waste up to n_dev x the compute
            pad = (super_block - rows) if pad_n > super_block else ((-rows) % n_dev)
            q = np.concatenate([Xp[start:stop], np.zeros((pad, d), np.float32)]) if pad else Xp[start:stop]
            qn = np.concatenate([norms[start:stop], np.full(pad, np.inf, np.float32)]) if pad else norms[start:stop]
            qi = np.concatenate([gidx[start:stop], np.full(pad, -1, np.int32)]) if pad else gidx[start:stop]
            dblk, iblk = fn(
                jax.device_put(q, data_sh), jax.device_put(qn, data_sh), jax.device_put(qi, data_sh),
                db, dbn, dbidx,
            )
            dists[start:stop] = np.asarray(dblk)[:rows]
            idxs[start:stop] = np.asarray(iblk)[:rows]
        return dists[:n], idxs[:n]

    db = jnp.asarray(db_np)
    dbn = jnp.asarray(dbn_np)
    dbidx = jnp.asarray(dbidx_np)
    for start in range(0, pad_n, block):
        qs = slice(start, start + block)
        dblk, iblk = _query_block_knn(
            jnp.asarray(Xp[qs]), jnp.asarray(norms[qs]), jnp.asarray(gidx[qs]), db, dbn, dbidx, k
        )
        dists[qs] = np.asarray(dblk)
        idxs[qs] = np.asarray(iblk)
    return dists[:n], idxs[:n]
