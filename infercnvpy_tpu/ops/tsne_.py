"""t-SNE in JAX (standalone replacement for sklearn's t-SNE used by scanpy).

The reference delegates to ``sc.tl.tsne`` (reference: tl/__init__.py:139).
Device formulation: sparse high-dimensional affinities from the exact kNN graph
(3·perplexity neighbors, like Barnes-Hut t-SNE), vectorized per-point beta
binary search, then full gradient descent where the O(N²) repulsive term is
computed from the 2-D embedding only — one small matmul-shaped pass per
iteration, no trees.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from .knn import exact_knn

__all__ = ["tsne_embed"]


@jax.jit
def _binary_search_beta(d2, target_entropy):
    """Per-row beta (precision) s.t. the conditional distribution's perplexity matches."""

    def body(_, state):
        beta, lo, hi = state
        p = jnp.exp(-d2 * beta[:, None])
        sum_p = jnp.maximum(jnp.sum(p, axis=1), 1e-12)
        H = jnp.log(sum_p) + beta * jnp.sum(d2 * p, axis=1) / sum_p
        too_high = H > target_entropy  # entropy too high -> increase beta
        new_lo = jnp.where(too_high, beta, lo)
        new_hi = jnp.where(too_high, hi, beta)
        new_beta = jnp.where(
            too_high,
            jnp.where(jnp.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            jnp.where(lo <= 0, beta / 2.0, (beta + new_lo) / 2.0),
        )
        return new_beta, new_lo, new_hi

    n = d2.shape[0]
    beta, _, _ = jax.lax.fori_loop(
        0, 64, body, (jnp.ones(n), jnp.zeros(n), jnp.full(n, jnp.inf))
    )
    p = jnp.exp(-d2 * beta[:, None])
    return p / jnp.maximum(jnp.sum(p, axis=1, keepdims=True), 1e-12)


def _row_block(n: int) -> int:
    """Row-tile size bounding the repulsion working set to ~128 MB."""
    rb = int(128e6 / (12.0 * max(n, 1)))
    return max(8, min(2048, (rb // 8) * 8, n))


@partial(jax.jit, static_argnames=("n_iter", "exag_iter", "n_valid", "rb"))
def _optimize(Y0, P_rows, P_cols, P_vals, n_iter, exag_iter, early_exaggeration, learning_rate, n_valid, rb):
    """Y0 is padded to a multiple of ``rb`` rows; rows >= n_valid are inert."""
    n_pad = Y0.shape[0]
    nb = n_pad // rb
    valid = (jnp.arange(n_pad) < n_valid).astype(jnp.float32)

    def grad_fn(Y, exag):
        # repulsive: blocked over row tiles — never materializes (n, n, ·).
        # Per tile:  q_ij = 1/(1+|y_i-y_j|²) via the matmul expansion of d²;
        # force_i = (Σ_j q²)·y_i − q²·Y  (one skinny matmul), Z accumulated.
        # Default matmul precision on purpose (TF32 on GPU tensor cores): a
        # layout's gradient tolerates ~1e-3 relative error, unlike PCA/kNN.
        sq = jnp.sum(Y * Y, axis=1)

        def rep_block(args):
            yb, sqb, base = args
            row_ok = ((base + jnp.arange(rb)) < n_valid).astype(jnp.float32)
            d2 = sqb[:, None] + sq[None, :] - 2.0 * (yb @ Y.T)
            q = 1.0 / (1.0 + jnp.maximum(d2, 0.0))
            q = q * valid[None, :] * row_ok[:, None]
            q = q.at[jnp.arange(rb), base + jnp.arange(rb)].set(0.0)
            q2 = q * q
            s = jnp.sum(q2, axis=1)
            force = s[:, None] * yb - q2 @ Y
            return force, jnp.sum(q)

        forces, zparts = jax.lax.map(
            rep_block,
            (Y.reshape(nb, rb, 2), sq.reshape(nb, rb), jnp.arange(nb, dtype=jnp.int32) * rb),
        )
        Z = jnp.maximum(jnp.sum(zparts), 1e-12)
        rep = forces.reshape(n_pad, 2) / Z
        # attractive: sparse over kNN edges
        pd = Y[P_rows] - Y[P_cols]
        pq = 1.0 / (1.0 + jnp.sum(pd * pd, axis=1))
        att = jnp.zeros_like(Y).at[P_rows].add((exag * P_vals * pq)[:, None] * pd)
        return 4.0 * (att - rep)

    def step(i, state):
        Y, vel, gains = state
        exag = jnp.where(i < exag_iter, early_exaggeration, 1.0)
        momentum = jnp.where(i < exag_iter, 0.5, 0.8)
        g = grad_fn(Y, exag)
        same_sign = jnp.sign(g) == jnp.sign(vel)
        gains = jnp.clip(jnp.where(same_sign, gains * 0.8, gains + 0.2), 0.01, None)
        vel = momentum * vel - learning_rate * gains * g
        Y = Y + vel * valid[:, None]
        Y = Y - jnp.sum(Y * valid[:, None], axis=0, keepdims=True) / n_valid
        return Y, vel, gains

    Y, _, _ = jax.lax.fori_loop(
        0, n_iter, step, (Y0, jnp.zeros_like(Y0), jnp.ones_like(Y0))
    )
    return Y


def tsne_embed(
    X: np.ndarray,
    *,
    perplexity: float = 30.0,
    n_components: int = 2,
    n_iter: int = 1000,
    early_exaggeration: float = 12.0,
    learning_rate: float = 200.0,
    seed: int = 0,
    max_cells: int | None = 50_000,
) -> np.ndarray:
    """Embed X (cells × features, usually the CNV PCA) into 2-D with t-SNE.

    The repulsive term is exact O(n²) work per iteration (blocked so memory
    stays bounded); above ``max_cells`` this is declined with guidance rather
    than left to run for hours — pass ``max_cells=None`` to override.
    """
    X = np.asarray(X, dtype=np.float32)
    n = X.shape[0]
    if max_cells is not None and n > max_cells:
        raise ValueError(
            f"t-SNE on {n} cells exceeds max_cells={max_cells}: the exact O(n²) "
            "repulsion would take hours at this size. Use tl.umap (scales near-"
            "linearly), subsample, or pass max_cells=None to force it."
        )
    perplexity = min(perplexity, max(1.0, (n - 1) / 3.0))
    k = int(min(n - 1, max(3, 3 * perplexity)))

    dists, idxs = exact_knn(X, k + 1)
    d2 = jnp.asarray(dists[:, 1:] ** 2)
    P_cond = np.asarray(_binary_search_beta(d2, jnp.log(jnp.asarray(perplexity))))

    rows = np.repeat(np.arange(n), k)
    cols = idxs[:, 1:].ravel()
    P = sp.coo_matrix((P_cond.ravel(), (rows, cols)), shape=(n, n)).tocsr()
    P = (P + P.T) / (2.0 * n)
    P = P.tocoo()

    rng = np.random.default_rng(seed)
    rb = _row_block(n)
    n_pad = -(-n // rb) * rb
    Y0 = (rng.standard_normal((n_pad, n_components)) * 1e-4).astype(np.float32)

    Y = _optimize(
        jnp.asarray(Y0),
        jnp.asarray(P.row.astype(np.int32)),
        jnp.asarray(P.col.astype(np.int32)),
        jnp.asarray(P.data.astype(np.float32)),
        int(n_iter),
        250,
        float(early_exaggeration),
        float(learning_rate),
        n,
        rb,
    )
    return np.asarray(Y[:n], dtype=np.float32)
