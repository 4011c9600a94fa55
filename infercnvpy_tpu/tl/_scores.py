"""Scores to summarize and assess copy number variation.

Behavioral contract follows reference tl/_scores.py:
* ``cnv_score``  — per-cluster mean of \\|X_cnv\\| broadcast to cells (:14-74)
* ``ithgex``     — per-group IQR of pairwise Pearson correlations of
  expression (:77-151)
* ``ithcna``     — same on the CNV matrix (:154-221)

Pearson correlation matrices are computed on device (standardize rows + one
matmul) for groups large enough to benefit; tiny groups run in numpy.
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping
from typing import Any

import numpy as np
import scipy.sparse as sp

from .._util import _choose_mtx_rep

__all__ = ["cnv_score", "ithcna", "ithgex"]

_JAX_MIN_ELEMENTS = 512 * 512  # below this, device round-trip isn't worth it


_SHARDED_CACHE: dict = {}


def _sharded_group_abs_fn(mesh, n_groups: int):
    """shard_map'd per-group |X| statistics: segment-sum per shard + psum.

    The library-level home of the collective cnv_score (SURVEY §5
    "all-reduce (psum) for cluster statistics", reference host counterpart
    tl/_scores.py:65-68).
    """
    import jax

    from ..parallel.mesh import mesh_key

    key = (*mesh_key(mesh), int(n_groups))
    if key not in _SHARDED_CACHE:
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from ..parallel.mesh import CELL_AXIS

        def f(x, codes):
            absrow = jnp.sum(jnp.abs(x), axis=1)
            # one extra segment (id == n_groups) absorbs padding rows
            s = jax.ops.segment_sum(absrow, codes, num_segments=n_groups + 1)
            cnt = jax.ops.segment_sum(jnp.ones_like(absrow), codes, num_segments=n_groups + 1)
            return jax.lax.psum(s, CELL_AXIS), jax.lax.psum(cnt, CELL_AXIS)

        C = P(CELL_AXIS)
        _SHARDED_CACHE[key] = jax.jit(
            jax.shard_map(f, mesh=mesh, in_specs=(C, C), out_specs=(P(), P()))
        )
    return _SHARDED_CACHE[key]


def _group_abs_mean_sharded(X, codes: np.ndarray, n_groups: int, mesh, block_rows: int = 65536):
    """Per-group mean |X| over a cell mesh; returns float64 (n_groups,)."""
    import jax

    from ..parallel.mesh import shard_cells

    n, d = X.shape
    n_dev = int(mesh.devices.size)
    fn = _sharded_group_abs_fn(mesh, n_groups)
    data_sh = shard_cells(mesh)
    sums = np.zeros(n_groups + 1, np.float64)
    cnts = np.zeros(n_groups + 1, np.float64)
    block_rows = max(n_dev, (block_rows // n_dev) * n_dev)
    for start in range(0, n, block_rows):
        blk = X[start : start + block_rows]
        blk = np.asarray(blk.todense() if sp.issparse(blk) else blk, dtype=np.float32)
        c = codes[start : start + block_rows].astype(np.int32)
        pad = (-blk.shape[0]) % n_dev
        if pad:
            blk = np.concatenate([blk, np.zeros((pad, d), np.float32)])
            c = np.concatenate([c, np.full(pad, n_groups, np.int32)])
        s, k = fn(jax.device_put(blk, data_sh), jax.device_put(c, data_sh))
        sums += np.asarray(s, np.float64)
        cnts += np.asarray(k, np.float64)
    return sums[:n_groups] / np.maximum(cnts[:n_groups] * d, 1.0)


def cnv_score(
    adata,
    groupby: str = "cnv_leiden",
    *,
    use_rep: str = "cnv",
    key_added: str = "cnv_score",
    inplace: bool = True,
    obs_key=None,
    mesh=None,
) -> Mapping[Any, np.number] | None:
    """Assign each cnv cluster a CNV score (mean |CNV| per cluster).

    Reference: tl/_scores.py:14-74.  ``mesh`` (a 1-D ``jax.sharding.Mesh``)
    switches to the collective path: rows shard over the cell axis, each
    device segment-sums |X| for its shard, and a ``psum`` combines the
    per-cluster statistics — the BASELINE configs 4-5 "all-reduce cnv_score".
    """
    if obs_key is not None:
        warnings.warn(
            "The obs_key argument has been renamed to `groupby` for consistency with "
            "other functions and will be removed in the future. ",
            category=FutureWarning,
            stacklevel=2,
        )
        groupby = obs_key

    if groupby not in adata.obs.columns and groupby == "cnv_leiden":
        raise ValueError("`cnv_leiden` not found in `adata.obs`. Did you run `tl.leiden`?")

    X = adata.obsm[f"X_{use_rep}"]
    groups = adata.obs[groupby].values
    uniques = list(adata.obs[groupby].unique())

    if mesh is not None and int(mesh.devices.size) > 1:
        code_of = {g: i for i, g in enumerate(uniques)}
        codes = np.fromiter((code_of[g] for g in np.asarray(groups)), dtype=np.int32, count=len(groups))
        means = _group_abs_mean_sharded(X, codes, len(uniques), mesh)
        cluster_score = {g: means[i] for i, g in enumerate(uniques)}
    else:
        cluster_score = {}
        for cluster in uniques:
            mask = np.asarray(groups == cluster)
            sub = X[mask, :]
            if sp.issparse(sub):
                # mean of |values| over the FULL dense extent (zeros count)
                cluster_score[cluster] = np.abs(sub).sum() / (sub.shape[0] * sub.shape[1])
            else:
                cluster_score[cluster] = np.mean(np.abs(np.asarray(sub)))

    if inplace:
        score_array = np.array([cluster_score[c] for c in adata.obs[groupby]])
        adata.obs[key_added] = score_array
        return None
    return cluster_score


def _pearson_corr(X: np.ndarray, mesh=None) -> np.ndarray:
    """Pairwise Pearson correlation of rows (np.corrcoef semantics)."""
    X = np.asarray(X, dtype=np.float64)
    if mesh is not None or X.shape[0] * X.shape[1] >= _JAX_MIN_ELEMENTS:
        from ..ops.corr import pearson_rows

        return np.asarray(pearson_rows(X, mesh=mesh))
    return np.corrcoef(X, rowvar=True)


def _ith_score(adata, groupby: str, get_matrix, mesh=None) -> dict:
    groups = adata.obs[groupby].unique()
    out = {}
    for group in groups:
        mask = np.asarray(adata.obs[groupby].values == group)
        X = get_matrix(mask)
        if sp.issparse(X):
            X = np.asarray(X.todense())
        if X.shape[0] <= 1:
            continue
        pcorr = _pearson_corr(X, mesh=mesh)
        q75, q25 = np.percentile(pcorr, [75, 25])
        out[group] = q75 - q25
    return out


def ithgex(
    adata,
    groupby: str,
    *,
    use_raw: bool | None = None,
    layer: str | None = None,
    inplace: bool = True,
    key_added: str = "ithgex",
    mesh=None,
) -> Mapping[str, float] | None:
    """ITHGEX diversity score based on gene expression (Wu2021).

    Reference: tl/_scores.py:77-151.  ``mesh`` shards each group's
    correlation-matrix matmul over the cell mesh (see
    :func:`infercnvpy_tpu.ops.corr.pearson_rows`).
    """
    scores = _ith_score(
        adata, groupby, lambda mask: _choose_mtx_rep(adata[mask, :], use_raw, layer), mesh=mesh
    )
    return _store_scores(adata, groupby, scores, key_added) if inplace else scores


def ithcna(
    adata,
    groupby: str,
    *,
    use_rep: str = "X_cnv",
    key_added: str = "ithcna",
    inplace: bool = True,
    mesh=None,
) -> Mapping[str, float] | None:
    """ITHCNA diversity score based on copy number variation (Wu2021).

    Reference: tl/_scores.py:154-221.  ``mesh`` as in :func:`ithgex`.
    """
    scores = _ith_score(adata, groupby, lambda mask: adata.obsm[use_rep][mask, :], mesh=mesh)
    return _store_scores(adata, groupby, scores, key_added) if inplace else scores


def _store_scores(adata, groupby, scores, key_added):
    obs_vals = np.empty(adata.shape[0])
    for group in adata.obs[groupby].unique():
        obs_vals[np.asarray(adata.obs[groupby].values == group)] = scores.get(group, np.nan)
    adata.obs[key_added] = obs_vals
    return None
