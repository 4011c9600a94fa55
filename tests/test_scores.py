"""Score golden values (reference: tests/test_scores.py)."""

import numpy as np
import pytest

import infercnvpy_tpu as cnv


def test_ithgex(adata_ithgex):
    res = cnv.tl.ithgex(adata_ithgex, "group", inplace=False)
    assert res["A"] == 0
    assert res["B"] == pytest.approx(1.2628, abs=0.001)


def test_ithcna(adata_ithgex):
    res = cnv.tl.ithcna(adata_ithgex, "group", inplace=False)
    assert res["A"] == pytest.approx(1.053, abs=0.001)
    assert res["B"] == 0


def test_cnv_score(adata_ithgex):
    res = cnv.tl.cnv_score(adata_ithgex, "group", inplace=False)
    assert res["A"] == pytest.approx(2.25, abs=0.001)
    assert res["B"] == pytest.approx(2.5, abs=0.001)


def test_scores_inplace(adata_ithgex):
    cnv.tl.ithgex(adata_ithgex, "group")
    cnv.tl.ithcna(adata_ithgex, "group")
    cnv.tl.cnv_score(adata_ithgex, "group")
    assert "ithgex" in adata_ithgex.obs.columns
    assert "ithcna" in adata_ithgex.obs.columns
    assert "cnv_score" in adata_ithgex.obs.columns


def test_pearson_corr_parity_across_device_switchover():
    """The device corr path (elements >= _JAX_MIN_ELEMENTS) must match the
    float64 np.corrcoef the reference uses (tl/_scores.py:137) — both just
    under and just over the switchover."""
    import numpy.testing as npt

    from infercnvpy_tpu.tl._scores import _JAX_MIN_ELEMENTS, _pearson_corr

    rng = np.random.default_rng(0)
    g = 1024
    for n in [(_JAX_MIN_ELEMENTS // g) - 4, (_JAX_MIN_ELEMENTS // g) + 4]:
        X = rng.normal(size=(n, g)) * rng.gamma(2.0, size=(n, 1))
        got = np.asarray(_pearson_corr(X))
        want = np.corrcoef(X, rowvar=True)
        npt.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_pearson_split_f32_path_accuracy():
    """The compensated double-f32 device path (used when x64 is off, JAX's
    default) stays within ~1e-5 of float64 np.corrcoef."""
    import numpy.testing as npt

    from infercnvpy_tpu.ops.corr import _pearson_rows_split

    rng = np.random.default_rng(1)
    X = rng.normal(size=(96, 2000)) * 3 + 1.5
    Xc = X - X.mean(axis=1, keepdims=True)
    Xn = Xc / np.sqrt(np.sum(Xc * Xc, axis=1, keepdims=True))
    hi = Xn.astype(np.float32)
    lo = (Xn - hi).astype(np.float32)
    got = np.asarray(_pearson_rows_split(hi, lo))
    want = np.corrcoef(X, rowvar=True)
    npt.assert_allclose(got, want, rtol=0, atol=2e-5)
