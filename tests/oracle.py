"""Test-only numpy oracle for the infercnv pipeline.

A direct, unoptimized transliteration of the reference semantics
(reference: tl/_infercnv.py:411-457 chunk pipeline, :179-244 running mean,
:247-291 gene averages, :301-356 per-chromosome loop, :120-161 chunk
fan-out/assembly) used as the ground truth for randomized differential
testing of the JAX path.  Keep this file boring: clarity over speed,
numpy only.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.sparse as sp

from infercnvpy_tpu.genome.plan import natural_sort


def _center_clip(x, reference, lfc_clip):
    """Steps 1+2: bounded logFC centering + clipping (reference :419-436)."""
    if reference.shape[0] == 1:
        xc = x - reference[0, :]
    else:
        ref_min = np.min(reference, axis=0)
        ref_max = np.max(reference, axis=0)
        xc = np.zeros(x.shape, dtype=x.dtype)
        above = x > ref_max
        below = x < ref_min
        xc[above] = (x - ref_max)[above]
        xc[below] = (x - ref_min)[below]
    return np.clip(xc, -lfc_clip, lfc_clip)


def _smooth_chromosome(sub, genes, window, step, calc_gene):
    """Step 3 for one chromosome (reference :179-244).

    Returns (smoothed, gene_frame or None)."""
    g = sub.shape[1]
    if window < g:
        r = np.arange(1, window + 1)
        pyr = np.minimum(r, r[::-1])
        sm = np.apply_along_axis(lambda row: np.convolve(row, pyr, mode="valid"), 1, sub) / pyr.sum()
        sel = np.arange(0, sm.shape[1], step)
        sm = sm[:, sel]
        frame = None
        if calc_gene:
            # gene value = mean of the window values of every sampled window
            # containing the gene (reference :247-291, dict-loop semantics)
            vals: dict = {}
            for wi, p in enumerate(sel):
                for j in range(window):
                    vals.setdefault(genes[p + j], []).append(sm[:, wi])
            frame = pd.DataFrame({gene: np.mean(np.stack(v, axis=0), axis=0) for gene, v in vals.items()})
        return sm, frame
    # small chromosome: single uniform-weight window (reference :227-244)
    sm = sub.mean(axis=1, keepdims=True)
    frame = pd.DataFrame({gene: sm[:, 0] for gene in genes}) if calc_gene else None
    return sm, frame


def oracle_chunk(x, var, reference, lfc_clip, window, step, dynamic_threshold, calc_gene=False):
    """One chunk of the pipeline (reference _infercnv_chunk :411-457)."""
    x = np.asarray(x, dtype=np.float64)
    xc = _center_clip(x, np.asarray(reference, dtype=np.float64), lfc_clip)

    chromosomes = natural_sort(
        [c for c in pd.unique(var["chromosome"].astype(str)) if c.startswith("chr") and c != "chrM"]
    )
    blocks = []
    frames = []
    chr_pos = {}
    pos = 0
    for c in chromosomes:
        genes = var.loc[var["chromosome"].astype(str) == c].sort_values("start").index.to_numpy()
        cols = var.index.get_indexer(genes)
        sm, frame = _smooth_chromosome(xc[:, cols], genes, window, step, calc_gene)
        chr_pos[c] = pos
        pos += sm.shape[1]
        blocks.append(sm)
        if calc_gene:
            frames.append(frame)

    x_sm = np.hstack(blocks)
    x_res = x_sm - np.median(x_sm, axis=1)[:, None]
    gene_res = None
    if calc_gene:
        gdf = pd.concat(frames, axis=1)
        gene_res = gdf - np.median(gdf.values, axis=1)[:, None]

    if dynamic_threshold is not None:
        thr = dynamic_threshold * np.std(x_res)
        x_res[np.abs(x_res) < thr] = 0
        if calc_gene:
            gene_res = gene_res.where(~(gene_res.abs() < thr), 0.0)
    return chr_pos, x_res, gene_res


def oracle_infercnv(
    expr,
    var,
    reference,
    *,
    lfc_clip=3.0,
    window_size=100,
    step=10,
    dynamic_threshold=1.5,
    chunksize=5000,
    calculate_gene_values=False,
    var_names=None,
):
    """Full chunked pipeline (reference infercnv driver :113-161).

    ``expr``/``var``/``reference`` are already gene-masked; ``var_names``
    (optional) is the FULL original gene axis for the gene-values reindex.
    Returns (chr_pos, x_res dense float64, per_gene_mtx or None).
    """
    if sp.issparse(expr):
        expr = expr.tocsr()
    n = expr.shape[0]
    chunks = []
    frames = []
    chr_pos = None
    for i in range(0, n, chunksize):
        block = expr[i : i + chunksize]
        if sp.issparse(block):
            block = block.toarray()
        cp, res, gframe = oracle_chunk(
            block, var, reference, lfc_clip, window_size, step, dynamic_threshold, calculate_gene_values
        )
        chr_pos = chr_pos or cp
        chunks.append(res)
        if calculate_gene_values:
            frames.append(gframe)

    x_res = np.vstack(chunks)
    per_gene = None
    if calculate_gene_values:
        gdf = pd.concat(frames, axis=0, ignore_index=True)
        cols = var.index if var_names is None else var_names
        per_gene = gdf.reindex(columns=cols, fill_value=np.nan).values
    return chr_pos, x_res, per_gene
