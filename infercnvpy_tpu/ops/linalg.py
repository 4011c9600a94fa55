"""Batched device linear algebra: truncated SVD / PCA of the cell×window matrix.

Replaces the reference's ARPACK path (reference: tl/__init__.py:66-71 calls
``sc.tl.pca(svd_solver="arpack", zero_center=False)``).  Design: accumulate
the (windows × windows) Gram matrix with blocked full-precision matmuls over
streamed row blocks (works for sparse inputs of any cell count), then a single
dense ``eigh`` on the small Gram matrix gives the top components.

Precision: the Gram approach squares the condition number, and *any* float32
representation of the Gram — however the products are computed — bounds tail
eigenvalues at ~2⁻²⁴ · (σ₁/σᵢ)² relative error (a double-f32 product scheme
was measured to change nothing: the storage ulp dominates).  So
``high_precision`` (default: on when jax x64 is enabled) switches to float64
end-to-end: with x64 enabled the blocked matmuls run in f64 on device;
without x64 the Gram/projection run in f64 on the host via BLAS — an opt-in
accuracy/throughput trade (~n·d² host FLOPs) for ill-conditioned inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..parallel.mesh import pad_rows as _pad_rows

__all__ = ["truncated_svd"]

#: every float32 product here runs at full precision: a default-precision
#: matmul may use TF32 on GPU tensor cores (~1e-3 relative), and the Gram
#: squares the condition number
_HI = jax.lax.Precision.HIGHEST


@jax.jit
def _gram_accum(G, block):
    return G + jnp.matmul(block.T, block, precision=_HI)


@jax.jit
def _col_sums(s, block):
    return s + jnp.sum(block, axis=0)


def _project(block, V):
    return np.asarray(jnp.matmul(jnp.asarray(block), V, precision=_HI))


# --- mesh-sharded building blocks (BASELINE configs 4-5: distributed PCA
# over the cell axis; SURVEY §2.4 "distributed PCA/kNN") ------------------

_SHARDED_CACHE: dict = {}


def _sharded_gram_fn(mesh):
    """jit(shard_map): rows sharded over the cell axis -> psum'd Gram (d×d)."""
    from ..parallel.mesh import mesh_key

    key = ("gram", mesh_key(mesh))
    if key not in _SHARDED_CACHE:
        from jax.sharding import PartitionSpec as P

        from ..parallel.mesh import CELL_AXIS

        def f(x):
            return jax.lax.psum(jnp.matmul(x.T, x, precision=_HI), CELL_AXIS)

        _SHARDED_CACHE[key] = jax.jit(
            jax.shard_map(f, mesh=mesh, in_specs=P(CELL_AXIS), out_specs=P())
        )
    return _SHARDED_CACHE[key]


def _sharded_project_fn(mesh):
    """jit(shard_map): row-sharded X @ replicated V -> row-sharded scores."""
    from ..parallel.mesh import mesh_key

    key = ("project", mesh_key(mesh))
    if key not in _SHARDED_CACHE:
        from jax.sharding import PartitionSpec as P

        from ..parallel.mesh import CELL_AXIS

        _SHARDED_CACHE[key] = jax.jit(
            jax.shard_map(
                lambda x, v: jnp.matmul(x, v, precision=_HI),
                mesh=mesh,
                in_specs=(P(CELL_AXIS), P()),
                out_specs=P(CELL_AXIS),
            )
        )
    return _SHARDED_CACHE[key]


def truncated_svd(
    X,
    n_comps: int,
    *,
    zero_center: bool = False,
    block_rows: int = 16384,
    dtype=np.float32,
    sign_convention: bool = True,
    high_precision: bool | None = None,
    mesh=None,
):
    """Top-``n_comps`` principal scores of X (cells × features).

    Returns (scores, components, singular_values):
    ``scores[i] = X[i] @ components.T`` — matching sklearn TruncatedSVD /
    non-centered PCA semantics used by the reference.

    high_precision
        ``None`` (default) enables the float64 path automatically when jax
        x64 is on.  ``True`` forces it: f64 device matmuls where the backend
        supports them, otherwise f64 host (BLAS) accumulation — exact for
        ill-conditioned inputs where the f32 Gram loses the tail components
        (singular values spanning ≳1e3).
    mesh
        A 1-D ``jax.sharding.Mesh`` over the cell axis: each row block is
        sharded across the mesh, every device accumulates the Gram of ITS
        rows, and one ``psum`` combines them — the distributed
        replacement for the reference's single-process ARPACK call
        (reference: tl/__init__.py:66-71; BASELINE configs 4-5).  Zero-row
        padding never changes the Gram, so results are device-count
        independent up to f32 summation order.  Ignored by the host-BLAS
        high-precision fallback (no-x64 backends).
    """
    n, d = X.shape
    n_comps = int(min(n_comps, min(n, d)))
    x64 = jax.config.read("jax_enable_x64")
    use_hp = x64 if high_precision is None else bool(high_precision)
    n_dev = int(mesh.devices.size) if mesh is not None else 1
    use_mesh = mesh is not None and n_dev > 1 and not (use_hp and not x64)

    def _blocks():
        for start in range(0, n, block_rows):
            blk = X[start : start + block_rows]
            yield start, blk.toarray() if sp.issparse(blk) else np.asarray(blk)

    def _device_gram(blk, acc_dtype):
        """One block's Gram on device: sharded psum on a mesh, else plain."""
        if use_mesh:
            from ..parallel.mesh import shard_cells

            b = jax.device_put(_pad_rows(blk.astype(acc_dtype, copy=False), n_dev), shard_cells(mesh))
            return np.asarray(_sharded_gram_fn(mesh)(b), dtype=np.float64)
        b = jnp.asarray(blk.astype(acc_dtype, copy=False))
        return np.asarray(jnp.matmul(b.T, b, precision=_HI), dtype=np.float64)

    s64 = np.zeros(d, dtype=np.float64)
    if use_hp and x64:
        # float64 on device (CPU / x64-enabled backends)
        G64 = np.zeros((d, d), dtype=np.float64)
        for _, blk in _blocks():
            G64 += _device_gram(blk, np.float64)
            if zero_center:
                s64 += np.asarray(blk, dtype=np.float64).sum(axis=0)
    elif use_hp:
        # x64 disabled: exact f64 accumulation on the host
        G64 = np.zeros((d, d), dtype=np.float64)
        for _, blk in _blocks():
            b64 = np.asarray(blk, dtype=np.float64)
            G64 += b64.T @ b64
            if zero_center:
                s64 += b64.sum(axis=0)
    elif use_mesh:
        # f32 device matmuls, Gram partials psum'd over the mesh, f64 host sum
        G64 = np.zeros((d, d), dtype=np.float64)
        for _, blk in _blocks():
            G64 += _device_gram(blk, dtype)
            if zero_center:
                s64 += np.sum(blk, axis=0, dtype=np.float64)
    else:
        G = jnp.zeros((d, d), dtype=jnp.float32)
        s = jnp.zeros((d,), dtype=jnp.float32)
        for _, blk in _blocks():
            b = jnp.asarray(blk.astype(dtype, copy=False))
            G = _gram_accum(G, b)
            if zero_center:
                s = _col_sums(s, b)
        G64 = np.asarray(G, dtype=np.float64)
        s64 = np.asarray(s, dtype=np.float64)

    if zero_center:
        mu = s64 / n
        G64 = G64 - n * np.outer(mu, mu)

    # the Gram matrix is tiny (features × features) — a host f64 eigh is exact
    # enough for every path and costs nothing next to the accumulation
    evals, evecs = np.linalg.eigh(G64)  # ascending
    order = np.argsort(evals)[::-1][:n_comps]
    top_vals = np.maximum(evals[order], 0.0)
    V64 = evecs[:, order]  # (d, k)

    mu_np = (s64 / n) if zero_center else None
    out_dtype = np.float64 if use_hp else np.float32
    scores = np.empty((n, n_comps), dtype=out_dtype)

    # ship the (replicated) component matrix ONCE — re-uploading it per row
    # block would pay the H2D path this module exists to minimize
    V_host = V64 if use_hp else V64.astype(np.float32)
    if use_mesh:
        from ..parallel.mesh import replicate, shard_cells

        V_dev = jax.device_put(V_host, replicate(mesh))
        data_sh = shard_cells(mesh)
    elif not use_hp or x64:
        V_dev = jnp.asarray(V_host)

    def _project_mesh(b):
        rows = b.shape[0]
        bd = jax.device_put(_pad_rows(b, n_dev), data_sh)
        return np.asarray(_sharded_project_fn(mesh)(bd, V_dev))[:rows]

    for start, blk in _blocks():
        if use_hp and x64:
            b = blk.astype(np.float64, copy=False)
            if zero_center:
                b = b - mu_np
            proj = _project_mesh(b) if use_mesh else _project(b, V_dev)
            scores[start : start + blk.shape[0]] = proj
        elif use_hp:
            b64 = np.asarray(blk, dtype=np.float64)
            if zero_center:
                b64 = b64 - mu_np
            scores[start : start + blk.shape[0]] = b64 @ V_host
        else:
            b = blk.astype(np.float32, copy=False)
            if zero_center:
                b = b - mu_np.astype(np.float32)
            proj = _project_mesh(b) if use_mesh else _project(b, V_dev)
            scores[start : start + blk.shape[0]] = proj

    V_np = V64.astype(out_dtype)
    if sign_convention:
        # deterministic signs: largest-|loading| entry of each component positive
        # (sklearn svd_flip-style; makes runs reproducible across backends)
        flip = np.sign(V_np[np.argmax(np.abs(V_np), axis=0), np.arange(n_comps)])
        flip[flip == 0] = 1.0
        scores *= flip
        V_np = V_np * flip

    return scores, V_np.T, np.sqrt(top_vals)
