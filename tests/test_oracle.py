"""Randomized differential tests: JAX pipeline vs the numpy oracle.

The oracle (tests/oracle.py) is a direct transliteration of the reference
semantics; these property tests sweep window/step/reference-count/chunking
combinations the hand-written goldens don't reach (reference golden fixtures:
tests/conftest.py:61-108 cover only one 4x10 case).
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest

import infercnvpy_tpu as cnv

from oracle import oracle_infercnv


def _random_problem(seed, n_cells, chrom_sizes, n_ref, dtype=np.float64, dup_starts=False):
    rng = np.random.default_rng(seed)
    rows = []
    for c, g in enumerate(chrom_sizes):
        starts = rng.integers(1, 10_000_000, size=g)
        if dup_starts and g > 3:
            starts[1] = starts[0]  # exercise tie-order stability
        for s in starts:
            rows.append((f"chr{c + 1}", int(s)))
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    # shuffle gene order: the pipeline must sort by position per chromosome
    var = var.sample(frac=1.0, random_state=seed).reset_index(drop=True)
    var["end"] = var["start"] + 100
    var.index = pd.Index([f"gene{i}" for i in range(len(var))])

    X = rng.normal(size=(n_cells, len(var))).astype(dtype)
    cats = [f"cat{i}" for i in range(n_ref)]
    obs = pd.DataFrame({"group": [cats[i % n_ref] for i in range(n_cells)]})
    adata = cnv.AnnData(X=X, obs=obs, var=var)
    return adata, cats


CONFIGS = [
    # (seed, n_cells, chrom_sizes, n_ref, window, step, thr, chunksize, calc_gene)
    (0, 40, (120, 80), 2, 11, 3, 1.5, 5000, False),
    (1, 40, (120, 80), 1, 11, 3, 1.5, 5000, False),
    (2, 40, (120, 80), 3, 11, 3, 1.5, 5000, False),
    (3, 33, (120, 80), 2, 10, 3, 1.5, 5000, False),  # even window
    (4, 33, (120, 80), 2, 11, 1, 1.5, 5000, False),  # step 1
    (5, 33, (200, 150), 2, 50, 10, 1.5, 5000, False),
    (6, 33, (60, 9, 80, 3), 2, 11, 3, 1.5, 5000, False),  # small chromosomes
    (7, 33, (9, 3), 2, 11, 3, 1.5, 5000, False),  # ONLY small chromosomes
    (8, 47, (120, 80), 2, 11, 3, 1.5, 10, False),  # many chunks
    (9, 47, (120, 80), 2, 11, 3, 1.5, 13, False),  # chunk not dividing n
    (10, 47, (120, 80), 2, 11, 3, None, 5000, False),  # no noise gate
    (11, 40, (120, 80), 2, 11, 3, 1.5, 5000, True),  # gene values
    (12, 40, (120, 80), 1, 10, 4, 1.5, 5000, True),  # gene values, even window
    (13, 40, (90, 9, 70), 2, 11, 3, 1.5, 5000, True),  # gene values + small chrom
    (14, 40, (120, 80), 2, 11, 7, 1.5, 5000, True),  # step 7: uncovered genes -> NaN
    (15, 40, (120, 80), 2, 11, 3, 1.5, 7, True),  # gene values + chunking
    (16, 40, (120, 80), 2, 120, 10, 1.5, 5000, False),  # window == chrom size (small branch)
    (17, 40, (121, 80), 2, 120, 10, 1.5, 5000, False),  # window == chrom-1 (one window)
    (18, 40, (120, 80), 2, 11, 3, 0.5, 5000, False),  # aggressive gate
    (19, 40, (300,), 2, 31, 5, 1.5, 5000, False),  # single chromosome
    (20, 40, (120, 80), 2, 11, 3, 1.5, 5000, False),  # dup starts (below)
    (21, 64, (64, 64, 64), 2, 33, 2, 1.5, 17, True),  # everything at once
    (22, 40, (120, 80, 45, 2), 3, 44, 44, 1.5, 5000, False),  # step == window
    (23, 40, (128, 96), 2, 1, 1, 1.5, 5000, True),  # window 1 (identity-ish)
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=[f"cfg{c[0]}" for c in CONFIGS])
def test_matches_oracle(cfg):
    seed, n_cells, sizes, n_ref, window, step, thr, chunksize, calc_gene = cfg
    adata, cats = _random_problem(seed, n_cells, sizes, n_ref, dup_starts=(seed == 20))

    got_pos, got_res, got_gene = cnv.tl.infercnv(
        adata,
        reference_key="group",
        reference_cat=cats,
        window_size=window,
        step=step,
        dynamic_threshold=thr,
        chunksize=chunksize,
        calculate_gene_values=calc_gene,
        inplace=False,
        batch_cells=chunksize if chunksize < 100 else None,  # force multi-batch host loop
    )

    # oracle works on the already-masked inputs exactly like the reference driver
    ref = np.vstack(
        [np.mean(adata.X[np.asarray(adata.obs["group"].values == c), :], axis=0) for c in cats]
    )
    want_pos, want_res, want_gene = oracle_infercnv(
        adata.X,
        adata.var,
        ref,
        lfc_clip=3.0,
        window_size=window,
        step=step,
        dynamic_threshold=thr,
        chunksize=chunksize,
        calculate_gene_values=calc_gene,
        var_names=adata.var_names,
    )

    assert got_pos == want_pos
    got = got_res.toarray()
    scale = max(np.abs(want_res).max(), 1e-12)
    npt.assert_allclose(got, want_res, rtol=1e-6, atol=1e-6 * scale)
    # the noise gate must agree except for values within fp-noise of the threshold
    if thr is not None:
        gate_mismatch = (got == 0) != (want_res == 0)
        assert not gate_mismatch.any(), f"{gate_mismatch.sum()} gate mismatches"

    if calc_gene:
        assert got_gene.shape == want_gene.shape
        npt.assert_array_equal(np.isnan(got_gene), np.isnan(want_gene))
        m = ~np.isnan(want_gene)
        gscale = max(np.abs(want_gene[m]).max(), 1e-12)
        npt.assert_allclose(got_gene[m], want_gene[m], rtol=1e-6, atol=1e-6 * gscale)
    else:
        assert got_gene is None


GPU_CONFIGS = [
    # (seed, window, step): phase conv at step 10, cumsum at step 1 and 3
    (30, 100, 10),
    (31, 100, 1),
    (32, 31, 3),
]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", GPU_CONFIGS, ids=[f"gpu{c[0]}" for c in GPU_CONFIGS])
def test_gpu_pipeline_matches_oracle(gpu, cfg):
    """The GPU path (float32, its own smoothing choice) against the float64 oracle, ungated."""
    seed, window, step = cfg
    adata, cats = _random_problem(seed, 64, (400, 300, 150), 2, dtype=np.float32)
    _, got_res, got_gene = cnv.tl.infercnv(
        adata, reference_key="group", reference_cat=cats, window_size=window, step=step,
        dynamic_threshold=None, calculate_gene_values=True, inplace=False,
    )
    ref = np.vstack(
        [np.mean(adata.X[np.asarray(adata.obs["group"].values == c), :], axis=0, dtype=np.float64) for c in cats]
    )
    _, want_res, want_gene = oracle_infercnv(
        adata.X, adata.var, ref, window_size=window, step=step, dynamic_threshold=None,
        calculate_gene_values=True, var_names=adata.var_names,
    )
    # float32 on the device vs float64: values are clipped to +-3, so 1e-4 is ~100 ulps
    npt.assert_allclose(got_res.toarray(), want_res, rtol=0, atol=1e-4)
    m = ~np.isnan(want_gene)
    npt.assert_array_equal(np.isnan(got_gene), ~m)
    npt.assert_allclose(got_gene[m], want_gene[m], rtol=0, atol=1e-4)
