"""Downstream analysis ops: PCA, kNN, fuzzy graph, UMAP, t-SNE quality."""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sp

from infercnvpy_tpu.ops.graph import fuzzy_connectivities, knn_distance_matrix
from infercnvpy_tpu.ops.knn import exact_knn
from infercnvpy_tpu.ops.linalg import truncated_svd
from infercnvpy_tpu.ops.tsne_ import tsne_embed
from infercnvpy_tpu.ops.umap_ import umap_layout


@pytest.fixture(scope="module")
def blobs():
    """3 well-separated Gaussian blobs in 20 dims."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=20, size=(3, 20))
    X = np.vstack([centers[i] + rng.normal(size=(50, 20)) for i in range(3)]).astype(np.float32)
    labels = np.repeat(np.arange(3), 50)
    return X, labels


def test_truncated_svd_reconstruction():
    rng = np.random.default_rng(0)
    # low-rank + noise
    U = rng.normal(size=(200, 5))
    V = rng.normal(size=(5, 80))
    X = (U @ V).astype(np.float32)
    scores, components, svals = truncated_svd(X, 5)
    recon = scores @ components
    npt.assert_allclose(recon, X, atol=1e-2)
    assert (np.diff(svals) <= 1e-3).all()  # descending


def test_truncated_svd_matches_numpy_svd():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(120, 40)).astype(np.float32)
    scores, components, svals = truncated_svd(X, 10)
    s_np = np.linalg.svd(X.astype(np.float64), compute_uv=False)[:10]
    npt.assert_allclose(svals, s_np, rtol=1e-3)


def _ill_conditioned(n=300, d=50, span=1e4, seed=3):
    """Matrix with singular values spanning `span` (condition^2 kills f32 Gram)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(n, d)))
    v, _ = np.linalg.qr(rng.normal(size=(d, d)))
    svals = np.logspace(np.log10(span), 0, d)
    return (u * svals) @ v.T, svals


@pytest.mark.parametrize("force_host_f64", [False, True])
def test_truncated_svd_high_precision_ill_conditioned(force_host_f64):
    """All 50 components of an ill-conditioned matrix (sigma spanning 1e4) must
    match numpy SVD at rtol 1e-6 on both high-precision paths: device float64
    (auto under x64) and host-BLAS float64 (what a run without x64 takes)."""
    import jax

    from infercnvpy_tpu.ops import linalg as L

    X, svals_true = _ill_conditioned()
    if force_host_f64:
        # exercise the host-f64 branch directly (what a run without x64 takes)
        # by disabling the x64 fast path
        orig = jax.config.read("jax_enable_x64")
        try:
            jax.config.update("jax_enable_x64", False)
            scores, components, svals = L.truncated_svd(X, 50, high_precision=True)
        finally:
            jax.config.update("jax_enable_x64", orig)
    else:
        scores, components, svals = L.truncated_svd(X, 50, high_precision=None)  # auto: x64 on
    rtol = 1e-6
    npt.assert_allclose(svals, svals_true[:50], rtol=rtol)
    # scores must reproduce X @ components.T at the same accuracy
    npt.assert_allclose(scores, X @ components.T, rtol=1e-4, atol=float(svals_true[0]) * rtol)
    # plain f32 path demonstrably fails on the tail components at the same
    # tolerance (sanity that the test actually discriminates)
    _, _, svals_f32 = L.truncated_svd(X, 50, high_precision=False)
    assert not np.allclose(svals_f32, svals_true[:50], rtol=rtol)


def test_truncated_svd_sparse_and_blocked():
    rng = np.random.default_rng(2)
    X = sp.random(500, 60, density=0.2, format="csr", random_state=2, dtype=np.float32)
    s1, c1, v1 = truncated_svd(X, 8, block_rows=128)
    s2, c2, v2 = truncated_svd(X.toarray(), 8)
    npt.assert_allclose(np.abs(s1), np.abs(s2), rtol=1e-2, atol=1e-3)


def test_truncated_svd_zero_center():
    rng = np.random.default_rng(3)
    X = rng.normal(loc=5.0, size=(100, 30)).astype(np.float32)
    scores, components, svals = truncated_svd(X, 5, zero_center=True)
    # centered PCA scores should themselves be (approximately) centered
    npt.assert_allclose(scores.mean(axis=0), 0, atol=1e-2)


def test_exact_knn_matches_bruteforce():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 12)).astype(np.float32)
    dists, idxs = exact_knn(X, 10, block=128)
    # self first
    npt.assert_array_equal(idxs[:, 0], np.arange(300))
    npt.assert_allclose(dists[:, 0], 0, atol=1e-5)
    # brute force
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    want = np.sort(D, axis=1)[:, :10]
    npt.assert_allclose(np.sort(dists, axis=1), want, atol=1e-3)


def test_fuzzy_connectivities_properties(blobs):
    X, labels = blobs
    dists, idxs = exact_knn(X, 15)
    conn = fuzzy_connectivities(dists, idxs)
    assert conn.shape == (150, 150)
    assert abs(conn - conn.T).max() < 1e-6  # symmetric
    assert conn.max() <= 1.0 + 1e-6 and conn.min() >= 0
    # blob structure: within-blob weight dominates
    w_in = conn[:50, :50].sum()
    w_out = conn[:50, 50:].sum()
    assert w_in > 10 * w_out


def test_knn_distance_matrix(blobs):
    X, _ = blobs
    dists, idxs = exact_knn(X, 5)
    D = knn_distance_matrix(dists, idxs)
    assert D.shape == (150, 150)
    assert D.nnz == 150 * 4  # self excluded
    assert D.diagonal().sum() == 0


def _blob_separation(emb, labels):
    """Mean inter-centroid distance / mean within-blob spread."""
    cents = np.vstack([emb[labels == i].mean(0) for i in range(3)])
    inter = np.linalg.norm(cents[:, None] - cents[None, :], axis=-1).sum() / 6
    intra = np.mean([np.linalg.norm(emb[labels == i] - cents[i], axis=1).mean() for i in range(3)])
    return inter / intra


def test_umap_separates_blobs(blobs):
    X, labels = blobs
    dists, idxs = exact_knn(X, 15)
    conn = fuzzy_connectivities(dists, idxs)
    emb = umap_layout(conn, n_epochs=150, seed=0)
    assert emb.shape == (150, 2)
    assert np.isfinite(emb).all()
    assert _blob_separation(emb, labels) > 2.0


def test_tsne_separates_blobs(blobs):
    X, labels = blobs
    emb = tsne_embed(X, n_iter=400, perplexity=20, seed=0)
    assert emb.shape == (150, 2)
    assert np.isfinite(emb).all()
    assert _blob_separation(emb, labels) > 2.0


def test_umap_tsne_trustworthiness(blobs):
    """Quantitative embedding quality: sklearn's trustworthiness metric
    (fraction of local neighborhoods preserved, 0.5 ~ random, 1.0 perfect)
    — a real quality bar that runs in this environment, unlike the
    umap-learn/scanpy differentials that importorskip away here."""
    sklearn_manifold = pytest.importorskip("sklearn.manifold")
    trustworthiness = sklearn_manifold.trustworthiness

    X, labels = blobs
    dists, idxs = exact_knn(X, 15)
    conn = fuzzy_connectivities(dists, idxs)
    emb_u = umap_layout(conn, n_epochs=200, seed=0)
    emb_t = tsne_embed(X, n_iter=400, perplexity=20, seed=0)
    rng = np.random.default_rng(0)
    emb_rand = rng.normal(size=(X.shape[0], 2))
    t_u = trustworthiness(X, emb_u, n_neighbors=12)
    t_t = trustworthiness(X, emb_t, n_neighbors=12)
    t_r = trustworthiness(X, emb_rand, n_neighbors=12)
    assert t_u > 0.90, f"umap trustworthiness {t_u:.3f}"
    assert t_t > 0.90, f"tsne trustworthiness {t_t:.3f}"
    assert t_r < 0.75  # sanity: the bar actually separates random layouts


def test_tsne_max_cells_guard():
    """Oversized t-SNE inputs get a clear error with guidance instead of an
    hours-long O(n^2) run; max_cells=None overrides."""
    import numpy as np
    import pytest

    from infercnvpy_tpu.ops.tsne_ import tsne_embed

    X = np.random.default_rng(0).normal(size=(64, 5)).astype(np.float32)
    with pytest.raises(ValueError, match="max_cells"):
        tsne_embed(X, max_cells=50)
    Y = tsne_embed(X, max_cells=None, n_iter=20)
    assert Y.shape == (64, 2)
