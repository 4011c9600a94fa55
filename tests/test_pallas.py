"""The pipeline's per-row median and its smoothing formulations."""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest

from infercnvpy_tpu.ops.infercnv_kernel import row_median


@pytest.mark.parametrize("shape", [(8, 9), (16, 1793), (8, 1794), (8, 2)])
def test_row_median_exact(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    x[0, :] = 0.0
    if shape[0] > 1:
        x[1, : shape[1] // 2] = -1.5
    got = np.asarray(row_median(x))
    want = np.median(x, axis=1).astype(np.float32)
    npt.assert_array_equal(got, want)


def test_row_median_negatives_and_ties():
    x = np.array(
        [
            [-1.0, -1.0, -1.0, 5.0],
            [0.0, -0.0, 1.0, -1.0],
            [np.float32(1e-38), np.float32(-1e-38), 2.0, -2.0],
        ],
        dtype=np.float32,
    )
    got = np.asarray(row_median(x))
    want = np.median(x, axis=1).astype(np.float32)
    npt.assert_array_equal(got, want)


def test_row_median_wide_auto_tile():
    """20k-wide rows (the gene-values width) stay exact."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 20000)).astype(np.float32)
    got = np.asarray(row_median(x))
    npt.assert_array_equal(got, np.median(x, axis=1).astype(np.float32))


def _toy_var():
    rows = [(f"chr{c + 1}", i * 100) for c, g in enumerate([150, 40, 7, 90]) for i in range(g)]
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1
    return var


def _run_modes(window, step, n_ref, threshold, n_cells, gene_values, seed):
    import jax.numpy as jnp

    from infercnvpy_tpu.genome import build_window_plan
    from infercnvpy_tpu.ops.infercnv_kernel import _pack_lut, build_infercnv_fn, pack_columns

    rng = np.random.default_rng(seed)
    var = _toy_var()
    plan = build_window_plan(var, window, step)
    lut = _pack_lut(plan, len(var))
    x = pack_columns(rng.normal(size=(n_cells, len(var))).astype(np.float32), plan, lut)
    ref = pack_columns(rng.normal(size=(n_ref, len(var))).astype(np.float32), plan, lut)
    cid = (np.arange(n_cells) // 10).astype(np.int32)
    n_chunks = int(cid.max()) + 1
    out = {}
    for mode in ("phase", "cumsum", "conv"):
        fn = build_infercnv_fn(
            plan, n_ref_rows=n_ref, lfc_clip=1.0, dynamic_threshold=threshold, num_chunks=n_chunks,
            calculate_gene_values=gene_values, dtype=jnp.float32, smooth_mode=mode,
        )
        out[mode] = tuple(None if a is None else np.asarray(a) for a in fn(x, ref, cid))
    return out


@pytest.mark.parametrize("window,step,n_ref,threshold", [(100, 10, 2, 1.5), (9, 3, 1, 1.5), (11, 1, 3, None)])
def test_smoothing_formulations_agree(window, step, n_ref, threshold):
    """phase conv, cumsum and direct strided conv give the same gated windows."""
    out = _run_modes(window, step, n_ref, threshold, n_cells=37, gene_values=False, seed=0)
    for mode in ("cumsum", "conv"):
        npt.assert_allclose(out[mode][0], out["phase"][0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window,step,threshold", [(100, 10, 1.5), (9, 3, None), (11, 7, 1.5)])
def test_smoothing_formulations_agree_gene_values(window, step, threshold):
    out = _run_modes(window, step, 2, threshold, n_cells=21, gene_values=True, seed=3)
    ga = out["phase"][1]
    for mode in ("cumsum", "conv"):
        gb = out[mode][1]
        npt.assert_array_equal(np.isnan(ga), np.isnan(gb))
        m = ~np.isnan(ga)
        npt.assert_allclose(gb[m], ga[m], rtol=1e-5, atol=1e-5)


def test_gene_projection_cache_pins_plan():
    """The gpd cache must key on the live plan object — a recycled id() must
    never serve stale projection data (ADVICE r3 medium)."""
    from infercnvpy_tpu.genome import build_window_plan
    from infercnvpy_tpu.genome.plan import _gpd_cache, gene_projection_data

    rows = [(f"chr{c + 1}", i * 100) for c, g in enumerate([30, 20]) for i in range(g)]
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1
    plan = build_window_plan(var, 10, 2)
    gpd1 = gene_projection_data(plan)
    assert gene_projection_data(plan) is gpd1
    cached_plan, cached_gpd = _gpd_cache[id(plan)]
    assert cached_plan is plan and cached_gpd is gpd1


def test_clear_transform_caches_empties_gene_projection_cache():
    from infercnvpy_tpu.genome import build_window_plan
    from infercnvpy_tpu.genome.plan import _gpd_cache, gene_projection_data
    from infercnvpy_tpu.tl import clear_transform_caches

    plan = build_window_plan(_toy_var(), 10, 2)
    gene_projection_data(plan)
    assert id(plan) in _gpd_cache
    clear_transform_caches()
    assert not _gpd_cache
