#!/usr/bin/env python
"""Smoke test of the main path on one GPU, through the public entry points.

Run from the root of a checkout, on a machine with an NVIDIA GPU::

    python chip_smoke.py [--seed N]          # one card
    python chip_smoke.py --four-cards        # the four-card mesh path only

Phases (one process, data made from ``--seed``):

0. environment: package versions, the card's name and power limit, native
   host libraries, the compile-cache directory;
1. tutorial: the 183-cell oligodendroglioma set, window 100, step 1, two
   reference categories, ``tl.infercnv`` -> ``tl.pca`` -> ``pp.neighbors`` ->
   ``tl.leiden`` -> ``tl.cnv_score``; ``X_cnv`` against the float64 oracle;
2. atlas: 102,400 cells x 20,000 genes, CSR at 5 %, window 100, step 10,
   chunksize 5000 (the default device-densify path); the first two chunks
   against the oracle, then the downstream chain;
3. gene values: 16,384 x 20,000 with ``calculate_gene_values=True``; the
   first chunk against the oracle;
4. downstream parity at 16,384 cells: ``truncated_svd`` against a float64
   Gram + ``eigh`` and ``exact_knn`` against float64 brute force.

``--four-cards`` runs only ``tl.infercnv`` on 1,024,000 x 20,000 over the
default four-card cell mesh against the same call on one card, and the
mesh-aware ``tl.pca`` / ``pp.neighbors`` / ``tl.cnv_score`` against the
same calls without a mesh on the first 204,800 cells of the result.

Tolerances (each comparison raises when it is exceeded):

* ``X_cnv`` and gene values: max |ours - oracle| <= 1e-4 over entries the
  noise gate treats alike.  The device computes in float32 and the oracle in
  float64; values are clipped to +-3 before smoothing, so float32 round-off
  stays near 1e-6.  An entry may be gated on one side only when its ungated
  oracle value lies within 1e-4 of the chunk threshold; such flips are
  counted and printed.
* singular values: rtol 1e-4 (the float32 Gram squares the condition
  number; the leading 50 components of these inputs lose far less).
* kNN: mean neighbour-set overlap >= 0.99 (float32 distances may reorder
  near-ties at the k-th neighbour).
* four cards vs one: the same 1e-4 rule, where a flip may only hit an entry
  within 1e-4 of the smallest surviving magnitude of its chunk; PCA variance
  and cnv_score to rtol 1e-4 (partial sums combine in another order);
  neighbour-graph overlap >= 0.999 (same inputs, so only ties may differ).

Any failure raises; the script never falls back to the CPU.  The last line
of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4
REF_CATS = ["Normal A", "Normal B"]


def require_gpu(count: int = 1):
    """The visible JAX devices, or an error when they are not ``count`` GPUs or more."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"chip_smoke needs a GPU; JAX found platform {devices[0].platform!r}")
    if len(devices) < count:
        raise RuntimeError(f"chip_smoke needs {count} GPUs; JAX found {len(devices)}")
    return devices


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of each card, from a process without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _log(msg: str) -> None:
    print(msg, flush=True)


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_var(n_genes: int, seed: int):
    """Gene annotations placed on chr1-22, X, Y in proportion to chromosome length."""
    import numpy as np
    import pandas as pd

    from infercnvpy_tpu.datasets import _CHR_MB

    rng = np.random.default_rng(seed)
    chroms = list(_CHR_MB)
    sizes = np.array([_CHR_MB[c] for c in chroms], dtype=float)
    counts = np.floor(sizes / sizes.sum() * n_genes).astype(int)
    counts[0] += n_genes - counts.sum()
    chrom_col, starts = [], []
    for c, k in zip(chroms, counts):
        chrom_col += [c] * int(k)
        starts.append(np.sort(rng.integers(1, _CHR_MB[c] * 1_000_000, size=int(k))))
    start = np.concatenate(starts)
    return pd.DataFrame(
        {"chromosome": chrom_col, "start": start, "end": start + 10_000},
        index=pd.Index([f"gene_{i}" for i in range(n_genes)]),
    )


def make_csr(n_cells: int, n_genes: int, density: float, seed: int):
    """CSR expression with exactly ``density`` of each row stored.

    Each row draws one column from every run of ``1/density`` genes (so rows
    are sorted and duplicate-free), with log1p(gamma) values.  Rows are made
    in blocks by a thread pool, each block from its own seeded stream.
    """
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import scipy.sparse as sp

    per_row = int(round(n_genes * density))
    stride = n_genes // per_row
    block = 16384
    n_blocks = -(-n_cells // block)
    streams = np.random.SeedSequence(seed).spawn(n_blocks)
    indices = np.empty(n_cells * per_row, dtype=np.int32)
    data = np.empty(n_cells * per_row, dtype=np.float32)
    base = np.arange(per_row, dtype=np.int32) * stride

    def fill(b):
        rng = np.random.default_rng(streams[b])
        r0, r1 = b * block, min((b + 1) * block, n_cells)
        sl = slice(r0 * per_row, r1 * per_row)
        idx = indices[sl].reshape(r1 - r0, per_row)
        idx[:] = base + rng.integers(0, stride, size=idx.shape, dtype=np.int32)
        data[sl] = np.log1p(rng.standard_gamma(2.0, size=(r1 - r0) * per_row, dtype=np.float32))

    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(n_blocks)))
    indptr = np.arange(n_cells + 1, dtype=np.int64) * per_row
    return sp.csr_matrix((data, indices, indptr), shape=(n_cells, n_genes))


def make_atlas(n_cells: int, n_genes: int, seed: int, density: float = 0.05):
    """AnnData of CSR expression with three cell types, two of them the reference."""
    import numpy as np
    import pandas as pd

    import infercnvpy_tpu as cnv

    labels = np.random.default_rng(seed).choice(["Malignant", *REF_CATS], size=n_cells, p=[0.6, 0.2, 0.2])
    obs = pd.DataFrame(
        {"cell_type": pd.Categorical(labels)}, index=pd.Index([f"cell_{i}" for i in range(n_cells)])
    )
    return cnv.AnnData(X=make_csr(n_cells, n_genes, density, seed + 1), obs=obs, var=make_var(n_genes, seed))


# ---------------------------------------------------------------------------
# checks against the oracle
# ---------------------------------------------------------------------------


def _oracle():
    sys.path.insert(0, str(ROOT / "tests"))
    import oracle

    return oracle


def _masked_inputs(adata, cats, n_rows):
    """Gene-masked expression rows, var and float64 reference, as tl.infercnv sees them."""
    import numpy as np

    chrom = adata.var["chromosome"]
    keep = (chrom.notnull() & ~chrom.isin(["chrX", "chrY"])).values
    X = adata.X.tocsr()
    labels = np.asarray(adata.obs["cell_type"].values)
    reference = np.vstack([np.asarray(X[labels == c].mean(axis=0), dtype=np.float64).ravel() for c in cats])
    return X[:n_rows][:, keep], adata.var.loc[keep, ["chromosome", "start", "end"]], reference[:, keep], keep


def _check_gated(name, ours, ungated, thr):
    """Compare gated device values with the oracle's ungated values and chunk thresholds."""
    import numpy as np

    gated = np.where(np.abs(ungated) < thr, 0.0, ungated)
    nan_ours, nan_gated = np.isnan(ours), np.isnan(gated)
    if not np.array_equal(nan_ours, nan_gated):
        raise AssertionError(f"{name}: NaN pattern differs from the oracle")
    ok = ~nan_gated
    err = np.abs(np.where(ok, ours, 0.0) - np.where(ok, gated, 0.0))
    off = err > TOL
    flips = off & (np.abs(np.abs(ungated) - thr) <= TOL)
    bad = off & ~flips
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries differ from the oracle by more than {TOL} "
            f"(first at [{r}, {c}]: ours {ours[r, c]!r}, oracle {gated[r, c]!r}, threshold {thr[r, 0]!r})"
        )
    max_err = float(err[~flips].max()) if (~flips).any() else 0.0
    _log(f"  {name}: max |err| {max_err:.3e} (tol {TOL}), gate flips within {TOL} of threshold: {int(flips.sum())}")


def check_against_oracle(
    name, adata, *, window, step, chunksize, n_rows, cats=REF_CATS, gene_values=False, threshold=1.5
):
    """Compare ``obsm["X_cnv"]`` (and gene values) of the first ``n_rows`` cells with the oracle."""
    import numpy as np

    expr, var, reference, keep = _masked_inputs(adata, cats, n_rows)
    _, ungated, per_gene = _oracle().oracle_infercnv(
        expr, var, reference, window_size=window, step=step, dynamic_threshold=None,
        chunksize=chunksize, calculate_gene_values=gene_values,
    )
    thr = np.empty((n_rows, 1))
    for s in range(0, n_rows, chunksize):
        thr[s : s + chunksize] = threshold * np.std(ungated[s : s + chunksize])
    ours = adata.obsm["X_cnv"][:n_rows].toarray().astype(np.float64)
    if ours.shape != ungated.shape:
        raise AssertionError(f"{name}: X_cnv shape {ours.shape} != oracle {ungated.shape}")
    _check_gated(f"{name} X_cnv", ours, ungated, thr)
    if gene_values:
        ours_g = np.asarray(adata.layers["gene_values_cnv"][:n_rows][:, keep], dtype=np.float64)
        _check_gated(f"{name} gene values", ours_g, per_gene, thr)


def _check_downstream_outputs(adata):
    import numpy as np

    n = adata.shape[0]
    if adata.obsm["X_cnv_pca"].shape[0] != n or not np.isfinite(adata.obsm["X_cnv_pca"]).all():
        raise AssertionError("X_cnv_pca is not finite or has the wrong shape")
    if adata.obsp["cnv_neighbors_connectivities"].shape != (n, n):
        raise AssertionError("neighbour graph has the wrong shape")
    if len(adata.obs["cnv_leiden"]) != n or not np.isfinite(adata.obs["cnv_score"].to_numpy()).all():
        raise AssertionError("leiden labels or cnv_score are missing or not finite")


def downstream_chain(name, adata, **kwargs):
    import infercnvpy_tpu as cnv

    times = {}
    for label, fn in (
        ("pca", cnv.tl.pca), ("neighbors", cnv.pp.neighbors), ("leiden", cnv.tl.leiden),
        ("cnv_score", cnv.tl.cnv_score),
    ):
        _, times[label] = _timed(fn, adata, **(kwargs if label != "leiden" else {}))
    _check_downstream_outputs(adata)
    _log(f"  {name} downstream seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    _log(f"  {name} leiden clusters: {adata.obs['cnv_leiden'].nunique()}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_environment():
    import importlib.metadata as md
    import platform

    import jax

    def version(dist):
        try:
            return md.version(dist)
        except md.PackageNotFoundError:
            return "missing"

    plugins = sorted(
        name for name in (d.metadata["Name"] or "" for d in md.distributions())
        if name.lower().replace("_", "-").startswith("jax-cuda")
    )
    _log("phase 0: environment")
    _log(f"  python {platform.python_version()}, jax {version('jax')}, jaxlib {version('jaxlib')}, "
         f"cuda plugin {', '.join(f'{p} {version(p)}' for p in plugins) or 'missing'}")
    _log(f"  numpy {version('numpy')}, scipy {version('scipy')}, pandas {version('pandas')}")
    from infercnvpy_tpu.native import native_available, native_pack_available

    _log(f"  native_pack_available {native_pack_available()}, native_available {native_available()}")
    _log(f"  compile cache: {jax.config.jax_compilation_cache_dir}")
    d = jax.devices()[0]
    _log(f"  jax device: {d.platform} {d.device_kind} x{len(jax.devices())}")


def phase_tutorial():
    import numpy as np

    import infercnvpy_tpu as cnv

    _log("phase 1: tutorial (183 cells, window 100, step 1)")
    adata = cnv.datasets.oligodendroglioma()
    cats = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]
    kw = dict(reference_key="cell_type", reference_cat=cats, window_size=100, step=1)
    _, cold = _timed(cnv.tl.infercnv, adata, **kw)
    warm = [_timed(cnv.tl.infercnv, adata, inplace=False, **kw)[1] for _ in range(5)]
    _log(f"  infercnv cold {cold:.3f} s, warm median of 5 {float(np.median(warm)):.4f} s "
         f"({adata.shape[0]} x {adata.shape[1]} -> {adata.obsm['X_cnv'].shape[1]} windows)")
    check_against_oracle("tutorial", adata, window=100, step=1, chunksize=5000, n_rows=adata.shape[0], cats=cats)
    downstream_chain("tutorial", adata)


def phase_atlas(seed: int, n_cells: int = 102_400, n_genes: int = 20_000, n_check: int = 10_000):
    import jax

    import infercnvpy_tpu as cnv
    from infercnvpy_tpu.tl import _infercnv

    _log(f"phase 2: atlas ({n_cells} x {n_genes} CSR at 5 %, window 100, step 10, chunksize 5000)")
    adata, t_data = _timed(make_atlas, n_cells, n_genes, seed)
    _log(f"  data made in {t_data:.1f} s (set-up), nnz {adata.X.nnz}")
    kw = dict(reference_key="cell_type", reference_cat=REF_CATS, window_size=100, step=10, chunksize=5000)
    _, cold = _timed(cnv.tl.infercnv, adata, **kw)
    _, warm = _timed(cnv.tl.infercnv, adata, **kw)
    dev = jax.devices()[0]
    _log(f"  infercnv cold {cold:.3f} s, warm {warm:.3f} s, {n_cells / warm:,.0f} cells/s, "
         f"mode {'device_densify' if _infercnv._LAST_RUN_INFO.get('device_densify') else 'host_pack'}")
    _log(f"  peak_bytes_in_use {(dev.memory_stats() or {}).get('peak_bytes_in_use')}")
    step = max(
        (c.memory_analysis() for c in _infercnv._EXEC_CACHE.values()), key=lambda m: m.temp_size_in_bytes
    )
    _log(f"  step memory_analysis: {step}")
    check_against_oracle("atlas", adata, window=100, step=10, chunksize=5000, n_rows=n_check)
    downstream_chain("atlas", adata)
    return adata


def phase_gene_values(seed: int, n_cells: int = 16_384, n_genes: int = 20_000, n_check: int = 5000):
    import infercnvpy_tpu as cnv

    _log(f"phase 3: gene values ({n_cells} x {n_genes}, calculate_gene_values=True)")
    adata = make_atlas(n_cells, n_genes, seed + 7)
    kw = dict(reference_key="cell_type", reference_cat=REF_CATS, window_size=100, step=10, chunksize=5000,
              calculate_gene_values=True)
    _, cold = _timed(cnv.tl.infercnv, adata, **kw)
    _, warm = _timed(cnv.tl.infercnv, adata, **kw)
    _log(f"  infercnv cold {cold:.3f} s, warm {warm:.3f} s")
    check_against_oracle(
        "gene-values run", adata, window=100, step=10, chunksize=5000, n_rows=n_check, gene_values=True
    )


def phase_downstream_parity(x_cnv, n: int = 16_384):
    import numpy as np

    from infercnvpy_tpu.ops.knn import exact_knn
    from infercnvpy_tpu.ops.linalg import truncated_svd

    k = 15
    _log(f"phase 4: downstream parity ({n} cells)")
    X = x_cnv[:n].toarray().astype(np.float32)
    scores, _, svals = truncated_svd(X, 50)
    X64 = X.astype(np.float64)
    evals = np.linalg.eigvalsh(X64.T @ X64)[::-1][:50]
    want = np.sqrt(np.maximum(evals, 0.0))
    rel = np.abs(svals - want) / np.maximum(want, 1e-30)
    _log(f"  truncated_svd singular values: max rel err {rel.max():.3e} (rtol {TOL})")
    if not np.allclose(svals, want, rtol=TOL, atol=0):
        raise AssertionError(f"singular values differ from float64 eigh by up to {rel.max():.3e}")
    _, idx = exact_knn(scores, k)
    S = scores.astype(np.float64)
    sq = (S * S).sum(axis=1)
    overlap = 0
    for s in range(0, n, 2048):
        d2 = sq[s : s + 2048, None] + sq[None, :] - 2.0 * S[s : s + 2048] @ S.T
        top = np.argpartition(d2, k - 1, axis=1)[:, :k]
        overlap += sum(len(set(a) & set(b)) for a, b in zip(top.tolist(), idx[s : s + 2048].tolist()))
    frac = overlap / (n * k)
    _log(f"  exact_knn neighbour-set overlap with float64 brute force: {frac:.5f} (min 0.99)")
    if frac < 0.99:
        raise AssertionError(f"kNN overlap {frac:.5f} < 0.99")


def _check_same_cnv(name, a, b, chunksize):
    """Compare two X_cnv results of the same input; gate flips only at the chunk threshold."""
    import numpy as np

    if a.shape != b.shape:
        raise AssertionError(f"{name}: shapes {a.shape} != {b.shape}")
    n_flips, max_err = 0, 0.0
    for s in range(0, a.shape[0], chunksize):
        x, y = a[s : s + chunksize].toarray(), b[s : s + chunksize].toarray()
        err = np.abs(x - y)
        off = err > TOL
        nz = np.abs(np.concatenate([x[x != 0], y[y != 0]]))
        thr = float(nz.min()) if nz.size else 0.0
        flips = off & ((x == 0) | (y == 0)) & (np.maximum(np.abs(x), np.abs(y)) <= thr + TOL)
        if (off & ~flips).any():
            raise AssertionError(f"{name}: chunk at cell {s} differs by {float(err[off & ~flips].max())!r}")
        n_flips += int(flips.sum())
        if (~flips).any():
            max_err = max(max_err, float(err[~flips].max()))
    _log(f"  {name}: max |err| {max_err:.3e} (tol {TOL}), gate flips at threshold: {n_flips}")


def phase_four_cards(seed: int, n_cells: int = 1_024_000, n_genes: int = 20_000, n_down: int = 204_800):
    import numpy as np

    import infercnvpy_tpu as cnv
    from infercnvpy_tpu.parallel.mesh import cell_mesh

    _log(f"four cards: {n_cells} x {n_genes} CSR at 5 %, window 100, step 10, chunksize 5000")
    adata, t_data = _timed(make_atlas, n_cells, n_genes, seed)
    _log(f"  data made in {t_data:.1f} s (set-up), nnz {adata.X.nnz}")
    kw = dict(reference_key="cell_type", reference_cat=REF_CATS, window_size=100, step=10, chunksize=5000)
    _, cold = _timed(cnv.tl.infercnv, adata, **kw)
    mesh_res = adata.obsm["X_cnv"]
    _log(f"  4-card mesh: first call {cold:.3f} s ({n_cells / cold:,.0f} cells/s, compile included)")
    (_, single_res, _), t_single = _timed(cnv.tl.infercnv, adata, inplace=False, mesh=False, **kw)
    _log(f"  1 card: first call {t_single:.3f} s ({n_cells / t_single:,.0f} cells/s, compile included)")
    _check_same_cnv("4 cards vs 1 card X_cnv", mesh_res, single_res, 5000)

    # downstream with and without the mesh on the first n_down cells of the
    # mesh result: exact kNN is O(n^2), and one card needs minutes at 10^6
    mesh = cell_mesh()
    obs = adata.obs.iloc[:n_down].copy()
    obs["cnv_leiden"] = (np.arange(n_down) % 8).astype(str)
    on_mesh = cnv.AnnData(obs=obs, obsm={"X_cnv": mesh_res[:n_down]})
    one = cnv.AnnData(obs=obs.copy(), obsm={"X_cnv": mesh_res[:n_down]})
    _log(f"  downstream on the first {n_down} cells")
    _, t_pca_m = _timed(cnv.tl.pca, on_mesh, mesh=mesh)
    _, t_pca_1 = _timed(cnv.tl.pca, one)
    va, vb = on_mesh.uns["cnv_pca"]["variance"], one.uns["cnv_pca"]["variance"]
    var_err = float(np.max(np.abs(va - vb) / vb))
    _log(f"  pca seconds: mesh {t_pca_m:.3f}, one card {t_pca_1:.3f}; variance max rel diff {var_err:.3e}")
    if var_err > TOL:
        raise AssertionError(f"mesh PCA variance differs from single-card PCA by {var_err:.3e}")
    # one PCA input for both neighbour searches isolates the kNN comparison
    one.obsm["X_cnv_pca"] = on_mesh.obsm["X_cnv_pca"]
    _, t_nn_m = _timed(cnv.pp.neighbors, on_mesh, mesh=mesh)
    _, t_nn_1 = _timed(cnv.pp.neighbors, one)
    sa, sb = (x.obsp["cnv_neighbors_distances"].copy() for x in (on_mesh, one))
    sa.data[:] = 1
    sb.data[:] = 1
    overlap = sa.multiply(sb).nnz / max(sa.nnz, 1)
    _log(f"  neighbors seconds: mesh {t_nn_m:.3f}, one card {t_nn_1:.3f}; neighbour overlap {overlap:.6f}")
    if overlap < 0.999:
        raise AssertionError(f"mesh kNN graph overlaps the single-card graph by only {overlap:.6f}")
    _, t_sc_m = _timed(cnv.tl.cnv_score, on_mesh, mesh=mesh)
    _, t_sc_1 = _timed(cnv.tl.cnv_score, one)
    ca, cb = on_mesh.obs["cnv_score"].to_numpy(), one.obs["cnv_score"].to_numpy()
    sc_err = float(np.max(np.abs(ca - cb) / np.abs(cb)))
    _log(f"  cnv_score seconds: mesh {t_sc_m:.3f}, one card {t_sc_1:.3f}; max rel diff {sc_err:.3e}")
    if sc_err > TOL:
        raise AssertionError(f"mesh cnv_score differs from the single-card score by {sc_err:.3e}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four-cards", action="store_true", help="run only the four-card mesh path")
    args = parser.parse_args(argv)
    if not (ROOT / "infercnvpy_tpu").is_dir():
        print("chip_smoke.py: the infercnvpy_tpu package is not next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    n_cards = 4 if args.four_cards else 1
    devices = require_gpu(n_cards)
    cards = card_line()
    phase_environment()
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(args.seed)
    else:
        phase_tutorial()
        atlas = phase_atlas(args.seed)
        phase_gene_values(args.seed)
        phase_downstream_parity(atlas.obsm["X_cnv"])
    _log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    _log(cards)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
