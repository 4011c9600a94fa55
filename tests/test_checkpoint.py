"""Batch checkpoint/resume for tl.infercnv (checkpoint_dir=).

The reference has no partial-work persistence (its only checkpoint is the
final h5ad); the driver streams each finished cell batch to disk and
resumes bit-identically.  SURVEY §5 (checkpoint/resume): "long multi-host
runs should stream per-shard results to disk".
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sp

from infercnvpy_tpu import tl
from infercnvpy_tpu.datasets import synthetic_cnv_dataset

REF_CAT = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]


def _run(adata, **kw):
    chr_pos, res, gene = tl.infercnv(
        adata,
        reference_key="cell_type",
        reference_cat=REF_CAT,
        inplace=False,
        chunksize=8,
        batch_cells=16,
        **kw,
    )
    return chr_pos, np.asarray(res.todense()), gene


@pytest.fixture
def adata():
    return synthetic_cnv_dataset(n_cells=48, n_genes=400, seed=3)


def test_checkpoint_matches_plain_run(adata, tmp_path):
    _, plain, _ = _run(adata)
    _, ck, _ = _run(adata, checkpoint_dir=tmp_path / "ck")
    npt.assert_array_equal(plain, ck)
    files = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert "manifest.json" in files
    assert sum(f.startswith("batch_") and f.endswith(".npz") for f in files) == 3  # 48/16 batches


@pytest.mark.parametrize("fmt", [None, sp.csr_matrix])
@pytest.mark.parametrize("mesh", [None, False])
def test_resume_loads_without_compute(tmp_path, monkeypatch, fmt, mesh):
    adata = synthetic_cnv_dataset(n_cells=48, n_genes=400, seed=3, sparse_format=fmt)
    _, first, _ = _run(adata, checkpoint_dir=tmp_path / "ck", mesh=mesh)

    # with every batch on disk, a resumed run must never build a kernel —
    # construction is lazy, so block EVERY builder entry point (dense, mesh,
    # and device-densify sparse) regardless of which path the input routes to
    import infercnvpy_tpu.ops.sparse_ingest as sparse_mod
    import infercnvpy_tpu.parallel.sharded as sharded_mod
    import infercnvpy_tpu.tl._infercnv as mod

    def boom(*a, **k):  # pragma: no cover - would indicate a failure
        raise AssertionError("compute path entered despite complete checkpoint")

    monkeypatch.setattr(mod, "build_infercnv_fn", boom)
    monkeypatch.setattr(sharded_mod, "sharded_infercnv_fn", boom)
    monkeypatch.setattr(sparse_mod, "build_sparse_infercnv_fn", boom)
    _, resumed, _ = _run(adata, checkpoint_dir=tmp_path / "ck", mesh=mesh)
    npt.assert_array_equal(first, resumed)


def test_resume_after_partial_run(adata, tmp_path):
    _, full, _ = _run(adata, checkpoint_dir=tmp_path / "ck")
    # simulate an interrupted run: drop the last batch file
    batches = sorted((tmp_path / "ck").glob("batch_*.npz"))
    batches[-1].unlink()
    _, resumed, _ = _run(adata, checkpoint_dir=tmp_path / "ck")
    npt.assert_array_equal(full, resumed)
    assert len(sorted((tmp_path / "ck").glob("batch_*.npz"))) == 3


def test_fingerprint_guards_config_change(adata, tmp_path):
    _run(adata, checkpoint_dir=tmp_path / "ck")
    with pytest.raises(ValueError, match="DIFFERENT configuration"):
        _run(adata, checkpoint_dir=tmp_path / "ck", lfc_clip=2.5)


def test_fingerprint_guards_data_change(adata, tmp_path):
    _run(adata, checkpoint_dir=tmp_path / "ck")
    adata2 = synthetic_cnv_dataset(n_cells=48, n_genes=400, seed=4)
    with pytest.raises(ValueError, match="DIFFERENT configuration"):
        _run(adata2, checkpoint_dir=tmp_path / "ck")


def test_checkpoint_with_gene_values(adata, tmp_path):
    _, plain, gplain = _run(adata, calculate_gene_values=True)
    _, ck, gck = _run(adata, calculate_gene_values=True, checkpoint_dir=tmp_path / "ck")
    npt.assert_array_equal(plain, ck)
    m = ~np.isnan(gplain)
    npt.assert_array_equal(m, ~np.isnan(gck))
    npt.assert_array_equal(gplain[m], gck[m])
    # resume path restores gene values too
    _, r, gr = _run(adata, calculate_gene_values=True, checkpoint_dir=tmp_path / "ck")
    npt.assert_array_equal(gplain[m], gr[m])


def test_checkpoint_sparse_input(tmp_path):
    adata = synthetic_cnv_dataset(n_cells=32, n_genes=300, seed=5, sparse_format=sp.csr_matrix)
    _, plain, _ = _run(adata)
    _, ck, _ = _run(adata, checkpoint_dir=tmp_path / "ck")
    npt.assert_array_equal(plain, ck)
