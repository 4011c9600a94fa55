"""Pairwise Pearson correlation on device (standardize + matmuls).

Used by tl.ithcna / tl.ithgex (reference computes float64 np.corrcoef
host-side, tl/_scores.py:137,207); here rows are standardized and the
correlations become (cells × cells) matmuls.

Precision: with jax x64 enabled the whole computation runs in float64 and
matches ``np.corrcoef`` to ~1e-13.  Without x64 (JAX's default), rows are
standardized in float64 on the host and split into double-float32 (hi, lo)
parts; the Gram matrix is then ``hi·hiᵀ + hi·loᵀ + lo·hiᵀ`` with HIGHEST
matmul precision — a compensated-f32 scheme whose residual error is the f32
accumulation of the dominant term (~1e-6 absolute on unit-norm rows) instead
of the ~1e-3 of a plain TF32 tensor-core matmul.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pearson_rows"]


@jax.jit
def _pearson_rows_f64(X):
    X = X - jnp.mean(X, axis=1, keepdims=True)
    norm = jnp.sqrt(jnp.sum(X * X, axis=1, keepdims=True))
    Xn = X / norm
    return jnp.clip(Xn @ Xn.T, -1.0, 1.0)


@jax.jit
def _pearson_rows_split(hi, lo):
    P = jax.lax.Precision.HIGHEST
    g = jnp.dot(hi, hi.T, precision=P) + jnp.dot(hi, lo.T, precision=P) + jnp.dot(lo, hi.T, precision=P)
    return jnp.clip(g, -1.0, 1.0)


_SHARDED_CACHE: dict = {}


def _sharded_stripe_fn(mesh, x64: bool):
    """shard_map'd correlation stripe: sharded rows × replicated full matrix.

    Each device computes its (n/n_dev × n) stripe of the correlation matrix
    — the O(n²·d) matmul FLOPs distribute over the mesh; the result gathers
    row-sharded (SURVEY §2.4 distributed-downstream direction).
    """
    from ..parallel.mesh import mesh_key

    key = (*mesh_key(mesh), x64)
    if key not in _SHARDED_CACHE:
        from jax.sharding import PartitionSpec as P

        from ..parallel.mesh import CELL_AXIS

        C = P(CELL_AXIS)
        if x64:

            def f(xs, xf):
                return jnp.clip(xs @ xf.T, -1.0, 1.0)

            mapped = jax.shard_map(f, mesh=mesh, in_specs=(C, P()), out_specs=C)
        else:

            def f(hs, ls, hf, lf):
                Pr = jax.lax.Precision.HIGHEST
                g = (
                    jnp.dot(hs, hf.T, precision=Pr)
                    + jnp.dot(hs, lf.T, precision=Pr)
                    + jnp.dot(ls, hf.T, precision=Pr)
                )
                return jnp.clip(g, -1.0, 1.0)

            mapped = jax.shard_map(f, mesh=mesh, in_specs=(C, C, P(), P()), out_specs=C)
        _SHARDED_CACHE[key] = jax.jit(mapped)
    return _SHARDED_CACHE[key]


def pearson_rows(X, mesh=None):
    """Correlation matrix of the rows of X (np.corrcoef semantics).

    ``mesh`` (1-D cell mesh) shards the row axis of the Gram: every device
    multiplies its row shard against the replicated standardized matrix, so
    the quadratic matmul cost splits across devices.  Standardization is
    identical to the single-device path, hence equal results up to matmul
    tiling order.
    """
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    n_dev = int(mesh.devices.size) if mesh is not None else 1
    use_mesh = mesh is not None and n_dev > 1
    x64 = jax.config.read("jax_enable_x64")

    if x64 and not use_mesh:
        return _pearson_rows_f64(jnp.asarray(X))

    # standardize in f64 host-side (shared by the split and sharded paths)
    Xc = X - X.mean(axis=1, keepdims=True)
    Xn = Xc / np.sqrt(np.sum(Xc * Xc, axis=1, keepdims=True))

    if use_mesh:
        from ..parallel.mesh import pad_rows as _pad_rows, replicate, shard_cells

        data_sh, repl_sh = shard_cells(mesh), replicate(mesh)
        fn = _sharded_stripe_fn(mesh, x64)
        if x64:
            xs = jax.device_put(_pad_rows(Xn, n_dev), data_sh)
            xf = jax.device_put(Xn, repl_sh)
            return np.asarray(fn(xs, xf))[:n]
        hi = Xn.astype(np.float32)
        lo = (Xn - hi).astype(np.float32)
        hs = jax.device_put(_pad_rows(hi, n_dev), data_sh)
        ls = jax.device_put(_pad_rows(lo, n_dev), data_sh)
        hf = jax.device_put(hi, repl_sh)
        lf = jax.device_put(lo, repl_sh)
        return np.asarray(fn(hs, ls, hf, lf))[:n]

    # double-f32 split for the single-device no-x64 Gram
    hi = Xn.astype(np.float32)
    lo = (Xn - hi).astype(np.float32)
    return _pearson_rows_split(jnp.asarray(hi), jnp.asarray(lo))
