"""Core tl.infercnv tests, pinned to the reference's golden values
(reference: tests/test_tools.py)."""

import numpy as np
import numpy.testing as npt
import pytest

import infercnvpy_tpu as cnv
from infercnvpy_tpu.tl._infercnv import _get_reference


def test_get_reference_key_and_cat(adata_mock):
    actual = _get_reference(adata_mock, "cat", ["foo", "baz"], None, layer=None)
    npt.assert_almost_equal(
        actual,
        np.array(
            [
                [1.5, 1, 1.5, 2],
                [7, 5, 5, 7],
            ]
        ),
    )


def test_get_reference_no_reference(adata_mock):
    actual = _get_reference(adata_mock, None, None, None, layer=None)
    npt.assert_almost_equal(actual, np.array([[4.8, 4.2, 4.4, 5]]), decimal=5)


def test_get_reference_given_reference(adata_mock):
    reference = np.array([1, 2, 3, 4])
    actual = _get_reference(adata_mock, "foo", "bar", reference, layer=None)
    npt.assert_equal(reference, actual[0, :])

    with pytest.raises(ValueError):
        reference = np.array([1, 2, 3])
        _get_reference(adata_mock, "foo", "bar", reference, layer=None)


def test_get_reference_missing_cat_raises(adata_mock):
    with pytest.raises(ValueError):
        _get_reference(adata_mock, "cat", ["does-not-exist"], None, layer=None)


@pytest.mark.parametrize(
    "reference_key,reference_cat",
    [
        (None, None),
        ("cell_type", ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]),
    ],
)
def test_infercnv(adata_oligodendroma, reference_key, reference_cat):
    cnv.tl.infercnv(adata_oligodendroma, reference_key=reference_key, reference_cat=reference_cat)
    assert "X_cnv" in adata_oligodendroma.obsm_keys(), "cnv not in adata.obsm"
    assert "cnv" in adata_oligodendroma.uns_keys(), "cnv not in adata.uns"
    assert "gene_values_cnv" not in adata_oligodendroma.layers.keys(), "gene_values_cnv in .layers"


def test_infercnv_gene_values(adata_oligodendroma):
    cnv.tl.infercnv(adata_oligodendroma, calculate_gene_values=True)
    assert "X_cnv" in adata_oligodendroma.obsm_keys()
    assert "cnv" in adata_oligodendroma.uns_keys()
    assert "gene_values_cnv" in adata_oligodendroma.layers.keys()
    gv = adata_oligodendroma.layers["gene_values_cnv"]
    assert gv.shape == adata_oligodendroma.shape


def test_infercnv_chunk_with_gene_values(adata_full_mock, gene_res_actual, x_res_actual):
    chr_pos, x_res, gene_res = cnv.tl.infercnv(
        adata_full_mock,
        lfc_clip=1,
        window_size=3,
        step=1,
        dynamic_threshold=1,
        exclude_chromosomes=None,
        calculate_gene_values=True,
        inplace=False,
    )
    npt.assert_allclose(gene_res, gene_res_actual.values, rtol=1e-6, atol=1e-12)
    npt.assert_allclose(x_res.toarray(), x_res_actual, rtol=1e-6, atol=1e-12)
    assert chr_pos == {"chr1": 0, "chr2": 3}, "chr_pos is not as expected"


def test_infercnv_chunk_default(adata_full_mock, x_res_actual):
    chr_pos, x_res, gene_res = cnv.tl.infercnv(
        adata_full_mock,
        lfc_clip=1,
        window_size=3,
        step=1,
        dynamic_threshold=1,
        exclude_chromosomes=None,
        inplace=False,
    )
    assert gene_res is None
    npt.assert_allclose(x_res.toarray(), x_res_actual, rtol=1e-6, atol=1e-12)
    assert chr_pos == {"chr1": 0, "chr2": 3}, "chr_pos is not as expected"


def test_infercnv_more_than_2_chunks(adata_full_mock, x_res_actual):
    chr_pos, res, per_gene_mtx = cnv.tl.infercnv(
        adata_full_mock,
        reference_key=None,
        reference_cat=None,
        reference=None,
        chunksize=2,
        lfc_clip=1,
        window_size=3,
        step=1,
        dynamic_threshold=1,
        exclude_chromosomes=None,
        calculate_gene_values=True,
        inplace=False,
    )
    npt.assert_allclose(per_gene_mtx[0], np.array([0.75, 0.0, 0.0, 0.0, -0.75, 0.0, 0.0, 0.0, 0.0, 0.75]), atol=1e-12)
    npt.assert_allclose(per_gene_mtx[3], np.array([0, 0, 0, 0, 0, 0.921875, 0.703125, 0, 0, 0]), atol=1e-12)
    npt.assert_allclose(res.toarray(), x_res_actual, rtol=1e-6, atol=1e-12)
    assert chr_pos == {"chr1": 0, "chr2": 3}, "chr_pos is not as expected"


def test_infercnv_batching_equivalence(adata_full_mock, x_res_actual):
    """Device batching must not change results (counterpart of the chunking test)."""
    _, res, _ = cnv.tl.infercnv(
        adata_full_mock,
        chunksize=2,
        batch_cells=2,
        lfc_clip=1,
        window_size=3,
        step=1,
        dynamic_threshold=1,
        exclude_chromosomes=None,
        inplace=False,
    )
    npt.assert_allclose(res.toarray(), x_res_actual, rtol=1e-6, atol=1e-12)


def test_infercnv_manual_reference(adata_oligodendroma):
    cnv.tl.infercnv(adata_oligodendroma, reference=np.ones(adata_oligodendroma.shape[1]))
    assert "X_cnv" in adata_oligodendroma.obsm_keys()


def test_infercnv_excludes_chromosomes(adata_oligodendroma):
    cnv.tl.infercnv(adata_oligodendroma)
    chr_pos = adata_oligodendroma.uns["cnv"]["chr_pos"]
    assert "chrX" not in chr_pos and "chrY" not in chr_pos
    cnv.tl.infercnv(adata_oligodendroma, exclude_chromosomes=None, key_added="cnv_all")
    assert "chrX" in adata_oligodendroma.uns["cnv_all"]["chr_pos"]


def test_infercnv_requires_genomic_position(adata_mock):
    with pytest.raises(ValueError):
        cnv.tl.infercnv(adata_mock)


def test_infercnv_empty_adata_raises(adata_oligodendroma):
    """Zero cells must raise a clear error, not a cryptic unpack failure (ADVICE r3)."""
    empty = adata_oligodendroma[:0].copy()
    with pytest.raises(ValueError, match="no cells"):
        cnv.tl.infercnv(empty)


def test_workflow(adata_oligodendroma):
    cnv.tl.infercnv(adata_oligodendroma)
    cnv.tl.pca(adata_oligodendroma)
    cnv.pp.neighbors(adata_oligodendroma)
    cnv.tl.tsne(adata_oligodendroma, n_iter=100)
    cnv.tl.umap(adata_oligodendroma, n_epochs=50)
    cnv.tl.leiden(adata_oligodendroma)
    cnv.tl.cnv_score(adata_oligodendroma)

    cnv.pl.umap(adata_oligodendroma, color=["cnv_score", "cnv_leiden"], show=False)
    cnv.pl.tsne(adata_oligodendroma, color=["cnv_score", "cnv_leiden"], show=False)
    cnv.pl.chromosome_heatmap(adata_oligodendroma, show=False)
    cnv.pl.chromosome_heatmap_summary(adata_oligodendroma, show=False)


def test_layer_parameter():
    adata = cnv.datasets.oligodendroglioma()
    adata.layers["LogNormalize"] = adata.X.copy()

    adata2 = adata.copy()
    adata2.X = adata.layers["LogNormalize"]

    cnv.tl.infercnv(adata, layer="LogNormalize")
    cnv.tl.infercnv(adata2, layer=None)

    X_cnv = adata.obsm["X_cnv"].toarray()
    X_cnv2 = adata2.obsm["X_cnv"].toarray()
    assert np.all(X_cnv == X_cnv2), "Different results found with infercnv layer parameter"


def test_infercnv_separates_tumor(adata_oligodendroma):
    """Malignant cells must show higher |CNV| than the normal reference cells."""
    cnv.tl.infercnv(
        adata_oligodendroma,
        reference_key="cell_type",
        reference_cat=["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"],
    )
    X = np.abs(adata_oligodendroma.obsm["X_cnv"].toarray())
    labels = np.asarray(adata_oligodendroma.obs["cell_type"])
    mal = X[labels == "Malignant"].mean()
    normal = X[labels != "Malignant"].mean()
    assert mal > 2 * normal, f"malignant |CNV| {mal} not >> normal {normal}"
