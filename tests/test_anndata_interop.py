"""Ecosystem interop for the standalone h5ad codec.

``core/h5ad.py`` claims to write the anndata on-disk spec; the round-trip
tests in test_core.py only prove self-consistency.  These tests prove the
exchange contract against the REAL ``anndata`` package whenever it is
importable (it is not shipped in this environment, so they skip here — but
they execute anywhere the wheel exists, e.g. a user's scanpy environment).
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

anndata = pytest.importorskip("anndata")

import infercnvpy_tpu as cnv
from infercnvpy_tpu.core.anndata import AnnData as OwnAnnData


def _sample_own_adata():
    rng = np.random.default_rng(0)
    X = sp.random(12, 7, density=0.4, format="csr", dtype=np.float32, random_state=1)
    obs = pd.DataFrame(
        {
            "cell_type": pd.Categorical(["a", "b", "c"] * 4),
            "score": rng.normal(size=12),
        },
        index=[f"cell{i}" for i in range(12)],
    )
    var = pd.DataFrame(
        {
            "chromosome": ["chr1"] * 4 + ["chr2"] * 3,
            "start": np.arange(7) * 1000,
            "end": np.arange(7) * 1000 + 500,
        },
        index=[f"gene{i}" for i in range(7)],
    )
    ad = OwnAnnData(X=X, obs=obs, var=var)
    ad.obsm["X_cnv"] = rng.normal(size=(12, 5)).astype(np.float32)
    ad.uns["cnv"] = {"chr_pos": {"chr1": 0, "chr2": 3}}
    ad.layers["dense"] = np.asarray(X.todense()) * 2.0
    return ad


def test_our_file_opens_in_real_anndata(tmp_path):
    ours = _sample_own_adata()
    path = tmp_path / "ours.h5ad"
    cnv.write_h5ad(path, ours)

    theirs = anndata.read_h5ad(path)
    assert theirs.shape == ours.shape
    assert list(theirs.obs_names) == list(ours.obs.index)
    assert list(theirs.var_names) == list(ours.var.index)
    npt.assert_allclose(
        np.asarray(theirs.X.todense()), np.asarray(ours.X.todense()), rtol=1e-6
    )
    assert list(theirs.obs["cell_type"]) == list(ours.obs["cell_type"])
    npt.assert_allclose(theirs.obs["score"].to_numpy(), ours.obs["score"].to_numpy())
    npt.assert_allclose(theirs.obsm["X_cnv"], ours.obsm["X_cnv"], rtol=1e-6)
    assert dict(theirs.uns["cnv"]["chr_pos"]) == ours.uns["cnv"]["chr_pos"]
    npt.assert_allclose(np.asarray(theirs.layers["dense"]), ours.layers["dense"], rtol=1e-6)


def test_real_anndata_file_opens_here(tmp_path):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(9, 6)).astype(np.float32)
    theirs = anndata.AnnData(
        X=sp.csr_matrix(X),
        obs=pd.DataFrame(
            {"grp": pd.Categorical(["x", "y", "z"] * 3)}, index=[f"c{i}" for i in range(9)]
        ),
        var=pd.DataFrame({"chromosome": ["chr1"] * 6}, index=[f"g{i}" for i in range(6)]),
    )
    theirs.obsm["X_pca"] = rng.normal(size=(9, 3))
    theirs.uns["meta"] = {"k": 3}
    path = tmp_path / "theirs.h5ad"
    theirs.write_h5ad(path)

    ours = cnv.read_h5ad(path)
    assert ours.shape == (9, 6)
    assert list(ours.obs.index) == list(theirs.obs_names)
    npt.assert_allclose(np.asarray(ours.X.todense()), X, rtol=1e-6)
    assert list(ours.obs["grp"]) == list(theirs.obs["grp"])
    npt.assert_allclose(ours.obsm["X_pca"], theirs.obsm["X_pca"])
    assert int(ours.uns["meta"]["k"]) == 3
