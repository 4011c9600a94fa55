"""`tl.infercnv` — the primary CNV-inference entry point.

API and numerics contract follow the reference driver
(reference: tl/_infercnv.py:18-161), but the execution model is the device's:

* no process fan-out — ONE jitted XLA program processes a whole device batch
  of cells (reference forks ``cpu_count()`` workers, :120-135);
* the reference's chunk-scoped noise std (:448-453) is reproduced exactly via
  a segmented reduction keyed on ``floor(cell_index / chunksize)``, so results
  are independent of device batching;
* sparse inputs are densified host-side in row batches and streamed to the
  device (reference densifies per chunk inside each worker).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import pandas as pd
import scipy.sparse as sp

from .._util import _ensure_array, warn
from ..genome.plan import _gpd_cache, build_window_plan, gene_projection_data
from ..ops.infercnv_kernel import _pack_lut, build_infercnv_fn, pack_columns, pack_csr, packed_width

__all__ = ["infercnv"]


def infercnv(
    adata,
    *,
    reference_key: str | None = None,
    reference_cat: None | str | Sequence[str] = None,
    reference: np.ndarray | None = None,
    lfc_clip: float = 3,
    window_size: int = 100,
    step: int = 10,
    dynamic_threshold: float | None = 1.5,
    exclude_chromosomes: Sequence[str] | None = ("chrX", "chrY"),
    chunksize: int = 5000,
    n_jobs: int | None = None,
    inplace: bool = True,
    layer: str | None = None,
    key_added: str = "cnv",
    calculate_gene_values: bool = False,
    batch_cells: int | None = None,
    dtype=None,
    mesh=None,
    device_densify: bool | None = None,
    checkpoint_dir=None,
    progress=None,
    transfer_dtype: str | None = None,
    compress_results: bool | None = None,
):
    """Infer Copy Number Variation (CNV) by averaging gene expression over genomic regions.

    Parameters mirror the reference (reference: tl/_infercnv.py:18-96).
    ``n_jobs`` is accepted for API compatibility but ignored (no process pool —
    the device pipeline is a single compiled program).  Additional parameters:

    batch_cells
        Number of cells per device batch.  ``None`` picks a multiple of
        ``chunksize`` targeting ~1.5 GB of dense input.  Does not affect numerics.
    dtype
        Compute dtype.  ``None`` uses float64 when the (densified) input is
        float64/int (matching numpy promotion in the reference), else float32.
    mesh
        Device placement.  ``None`` (default) uses ALL local devices: with
        more than one, each device batch is shard_map-ed over a 1-D cell mesh
        (chunk noise statistics are psum-ed, so results are independent of
        the device count).  Pass a 1-D ``jax.sharding.Mesh`` to control
        placement, or ``False`` to force single-device execution.
    device_densify
        For sparse input on a single device, ship the CSR arrays and densify
        on the accelerator (5–20× fewer host→device bytes at single-cell
        densities) instead of packing a dense block on the host.  ``None``
        (default) enables it automatically in that situation; ``False``
        forces the host packer.  Does not affect numerics.
    checkpoint_dir
        Stream each finished cell batch to this directory and resume an
        interrupted run with the same configuration (finished batches load
        from disk instead of recomputing; bit-identical results).  A
        fingerprint manifest refuses directories written by a different
        configuration.
    progress
        Per-batch progress reporting for long runs (the reference shows a
        tqdm bar, reference: tl/_infercnv.py:131).  ``None`` (default) logs a
        line per device batch at verbosity >= 2; ``True`` always prints to
        stderr; ``False`` disables; a callable receives a dict with
        ``cells_done / cells_total / elapsed_sec / cells_per_sec / eta_sec``.
    transfer_dtype
        Opt-in reduced-precision host→device transfer (``"bfloat16"`` or
        ``"float16"``): expression values ship at half the bytes and are
        upcast to the compute dtype on device.  Where the host→device
        transfer is the bottleneck, halving bytes buys wall time directly
        (not measured on a GPU yet).  ``None`` (default) ships
        full precision — bit-exact parity with the reference.  Only the
        input expression is reduced; all compute stays in the compute dtype.
    compress_results
        Fetch each batch's result as a nonzero bitmask + compacted values
        instead of the dense matrix (bit-identical CSR; 3-8× fewer
        device→host bytes at typical noise-gate survival).  On a
        mesh the compaction runs per shard under ``shard_map``.  ``None``
        (default) enables it automatically whenever the noise gate is on;
        ``False`` forces the dense fetch.
    """
    del n_jobs
    # validation: messages are observable API surface (reference tl/_infercnv.py:95-105)
    if adata.shape[0] == 0:
        raise ValueError("adata contains no cells — nothing to infer CNV from.")
    if not adata.var_names.is_unique:
        raise ValueError("Ensure your var_names are unique!")
    if not {"chromosome", "start", "end"}.issubset(adata.var.columns):
        raise ValueError(
            "Genomic positions not found. There need to be `chromosome`, `start`, and `end` columns in `adata.var`. "
        )

    # gene selection: drop unannotated genes (warn) and excluded chromosomes
    chrom = adata.var["chromosome"]
    n_unannotated = int(chrom.isnull().sum())
    if n_unannotated:
        warn(f"Skipped {n_unannotated} genes because they don't have a genomic position annotated. ")
    keep = chrom.notnull()
    if exclude_chromosomes is not None:
        keep &= ~chrom.isin(exclude_chromosomes)
    keep = keep.values

    reference = _get_reference(adata, reference_key, reference_cat, reference, layer)[:, keep]

    sub = adata[:, keep]
    expr = sub.X if layer is None else sub.layers[layer]
    if sp.issparse(expr):
        expr = expr.tocsr()
    var = sub.var.loc[:, ["chromosome", "start", "end"]]

    from ..profiling import maybe_trace

    with maybe_trace("infercnv"):
        chr_pos, res, per_gene_mtx = _infercnv_compute(
            expr,
            var,
            np.asarray(reference, dtype=np.float64),
            lfc_clip=lfc_clip,
            window_size=window_size,
            step=step,
            dynamic_threshold=dynamic_threshold,
            chunksize=chunksize,
            calculate_gene_values=calculate_gene_values,
            batch_cells=batch_cells,
            dtype=dtype,
            mesh=mesh,
            device_densify=device_densify,
            checkpoint_dir=checkpoint_dir,
            progress=progress,
            transfer_dtype=transfer_dtype,
            compress_results=compress_results,
        )

    if calculate_gene_values:
        # reindex used-gene values to the FULL original var axis, NaN elsewhere
        # (reference: tl/_infercnv.py:141-149)
        per_gene_df = pd.DataFrame(per_gene_mtx, index=adata.obs.index, columns=var.index)
        per_gene_df = per_gene_df.reindex(columns=adata.var_names, fill_value=np.nan)
        per_gene_mtx = per_gene_df.values
    else:
        per_gene_mtx = None

    if inplace:
        adata.obsm[f"X_{key_added}"] = res
        adata.uns[key_added] = {"chr_pos": chr_pos}
        if calculate_gene_values:
            adata.layers[f"gene_values_{key_added}"] = per_gene_mtx
        return None
    return chr_pos, res, per_gene_mtx


def _transfer_np_dtype(transfer_dtype):
    """Resolve the opt-in reduced-precision transfer dtype (None = full)."""
    if transfer_dtype is None:
        return None
    if str(transfer_dtype) in ("bf16", "bfloat16"):
        import ml_dtypes  # ships with jax

        return np.dtype(ml_dtypes.bfloat16)
    dt = np.dtype(transfer_dtype)
    if dt.kind != "f":
        raise ValueError(f"transfer_dtype must be a float dtype, got {transfer_dtype!r}")
    return dt


def _pick_dtype(expr, dtype):
    import jax.numpy as jnp

    if dtype is not None:
        return jnp.dtype(dtype) if not isinstance(dtype, str) else jnp.dtype(dtype)
    kind = expr.dtype.kind
    if kind in "iu" or expr.dtype == np.float64:
        # float64 math matches the reference's numpy promotion
        import jax

        if jax.config.read("jax_enable_x64"):
            return jnp.float64
        warn(
            f"Input dtype {expr.dtype} implies float64 math (the reference's numpy "
            "promotion), but jax x64 is disabled — computing in float32. "
            'Enable with jax.config.update("jax_enable_x64", True) or pass dtype= explicitly.'
        )
    return jnp.float32


#: execution details of the most recent `_infercnv_compute` call (test hook):
#: {"n_devices": int, "sharded": bool}
_LAST_RUN_INFO: dict = {}

#: module-level AOT executable cache: (id(jitted), arg signature) -> compiled.
#: The jitted transforms themselves are memoized module-level by their
#: builders, so their ids are stable for the process lifetime.  Bounded FIFO
#: (insertion order) so a long-lived service cycling through many distinct
#: genome/batch shapes cannot grow device/host memory without limit.
_EXEC_CACHE: dict = {}
_EXEC_CACHE_MAX = 64


def clear_transform_caches() -> None:
    """Drop every memoized transform and compiled executable.

    Frees the builder caches (jit objects and their traced programs), the
    AOT executable cache, the gene-projection cache, and the sharded-downstream transform caches
    (corr/knn/linalg/scores).  The next call of each path recompiles; use
    from long-lived services between unrelated workloads.
    """
    from ..ops import (
        corr as _corr,
        infercnv_kernel as _ik,
        knn as _knn,
        linalg as _lin,
        result_pack as _rp,
        sparse_ingest as _si,
    )
    from ..parallel import sharded as _sh
    from . import _scores

    _EXEC_CACHE.clear()
    _gpd_cache.clear()
    _ik._BUILD_CACHE.clear()
    _si._BUILD_CACHE.clear()
    _sh._BUILD_CACHE.clear()
    _corr._SHARDED_CACHE.clear()
    _knn._SHARDED_CACHE.clear()
    _lin._SHARDED_CACHE.clear()
    _scores._SHARDED_CACHE.clear()
    _rp._FN_CACHE.clear()


def _identity(out):
    return out


def _dense_to_csr(x_np: np.ndarray) -> sp.csr_matrix:
    """CSR-ify a dense result block (native two-pass OpenMP scan when built;
    the scipy constructor scans single-threaded)."""
    if x_np.dtype == np.float32:
        from ..native import native_dense_to_csr

        trip = native_dense_to_csr(x_np)
        if trip is not None:
            data, indices, indptr = trip
            return sp.csr_matrix((data, indices, indptr), shape=x_np.shape)
    return sp.csr_matrix(x_np)


def _compiled_executable(f, args):
    """Return ``(compiled, wrap_out, compile_sec)`` for transform ``f``.

    ``f`` is either a jit object or a wrapper exposing ``.jitted`` /
    ``.wrap_out`` (see :class:`..parallel.sharded._ShardedFn`).  The compiled
    executable is cached per argument signature; ``compile_sec`` is nonzero
    only on a cache miss.
    """
    import time as _time

    jitted = getattr(f, "jitted", f)
    wrap = getattr(f, "wrap_out", _identity)
    sig = tuple((tuple(a.shape), str(a.dtype)) for a in args)
    key = (id(jitted), sig)
    compiled = _EXEC_CACHE.get(key)
    compile_sec = 0.0
    if compiled is None:
        t0 = _time.perf_counter()
        compiled = jitted.lower(*args).compile()
        compile_sec = _time.perf_counter() - t0
        while len(_EXEC_CACHE) >= _EXEC_CACHE_MAX:
            _EXEC_CACHE.pop(next(iter(_EXEC_CACHE)))
        _EXEC_CACHE[key] = compiled
    return compiled, wrap, compile_sec


def _ckpt_fingerprint(
    expr, var, reference, n_cells, n_genes, window_size, step, lfc_clip, dynamic_threshold,
    chunksize, calculate_gene_values, batch_cells, cdtype, transfer_dtype=None,
) -> str:
    """Configuration hash guarding checkpoint reuse (any mismatch = new run).

    Sparse input is hashed EXACTLY — indptr, indices, and raw data bytes all
    enter the digest (sha256 streams ~1-2 GB/s, a fraction of one batch's
    compute even at 10⁹ nnz, with no copies).  Dense input is hashed exactly
    up to 1 GiB; above that it enters via per-row sums plus a column-weighted
    row projection (binds values to both their row AND column), avoiding an
    80 GB hash pass at the 1M-cell scale.
    """
    import hashlib

    h = hashlib.sha256()
    for item in (
        n_cells, n_genes, window_size, step, float(lfc_clip),
        None if dynamic_threshold is None else float(dynamic_threshold),
        chunksize, bool(calculate_gene_values), batch_cells, str(np.dtype(cdtype)),
        None if transfer_dtype is None else str(transfer_dtype),
    ):
        h.update(repr(item).encode())
    if sp.issparse(expr):
        x = expr.tocsr()
        h.update(repr((str(x.dtype), int(x.nnz))).encode())
        h.update(memoryview(np.ascontiguousarray(x.indptr)))
        h.update(memoryview(np.ascontiguousarray(x.indices)))
        h.update(memoryview(np.ascontiguousarray(x.data)))
    else:
        e_arr = np.asarray(expr)
        h.update(repr(str(e_arr.dtype)).encode())
        if e_arr.nbytes <= (1 << 30):
            h.update(memoryview(np.ascontiguousarray(e_arr)))
        else:
            row_sums = np.asarray(e_arr.sum(axis=1, dtype=np.float64))
            # deterministic pseudorandom column weights: one BLAS pass that
            # changes when any value moves between columns within a row
            w = np.random.default_rng(12345).normal(size=e_arr.shape[1])
            col_proj = e_arr @ (w if e_arr.dtype == np.float64 else w.astype(np.float32))
            h.update(np.ascontiguousarray(row_sums, dtype=np.float64).tobytes())
            h.update(np.ascontiguousarray(col_proj, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(np.asarray(reference, dtype=np.float64)).tobytes())
    h.update(",".join(var["chromosome"].astype(str)).encode())
    h.update(np.ascontiguousarray(var["start"].to_numpy(np.int64)).tobytes())
    return h.hexdigest()


def _infercnv_compute(
    expr,
    var: pd.DataFrame,
    reference: np.ndarray,
    *,
    lfc_clip: float,
    window_size: int,
    step: int,
    dynamic_threshold: float | None,
    chunksize: int,
    calculate_gene_values: bool,
    batch_cells: int | None,
    dtype,
    mesh=None,
    device_densify: bool | None = None,
    stats: dict | None = None,
    num_chunk_segments: int | None = None,
    checkpoint_dir=None,
    progress=False,
    transfer_dtype=None,
    compress_results=None,
):
    """Run the full pipeline; returns (chr_pos, csr result, used-gene matrix or None).

    ``stats`` (optional) — a dict that receives a per-stage timing breakdown:
    ``host_pack_sec``, ``h2d_sec``, ``h2d_bytes``, ``compute_sec``,
    ``d2h_sec``, ``csr_sec``, ``compile_sec``, ``mode``.  Collecting it
    serializes the software pipeline (each stage blocks), so totals with
    stats enabled are an upper bound on the pipelined wall time.

    ``num_chunk_segments`` — capacity of the chunk-noise segment reduction
    (must be >= the actual chunk count).  Runs over differently-sized inputs
    that share a capacity compile to the SAME executable; the default sizes
    the reduction exactly.

    ``checkpoint_dir`` — stream each finished cell batch to disk
    (``batch_<start>.npz``, written atomically) and, on a later call with the
    SAME configuration, resume by loading finished batches instead of
    recomputing them.  Batches are whole multiples of ``chunksize``, so the
    chunk-scoped noise gate makes every batch independent and the resumed
    result is bit-identical to an uninterrupted run.  A ``manifest.json``
    fingerprint guards against silently mixing configurations.  (The
    reference has no partial-work persistence at all — its only checkpoint
    is the final h5ad, reference: pl/_chromosome_heatmap.py:57-58.)
    """
    import time as _time

    import jax

    n_cells, n_genes = expr.shape
    if n_cells == 0:
        raise ValueError("adata contains no cells — nothing to infer CNV from.")
    plan = build_window_plan(var, window_size, step)
    if plan.n_windows == 0:
        raise ValueError("No usable chromosomes found (need `chr*` prefixed chromosome annotations).")

    cdtype = _pick_dtype(expr, dtype)
    tdt = _transfer_np_dtype(transfer_dtype)
    num_chunks = max(1, -(-n_cells // chunksize))
    if num_chunk_segments is not None:
        if num_chunk_segments < num_chunks:
            raise ValueError(f"num_chunk_segments {num_chunk_segments} < actual chunk count {num_chunks}")
        num_chunks = num_chunk_segments

    if batch_cells is None:
        # target ≈1.5 GB of dense input per batch, rounded to whole chunks
        target = max(1, int(1.5e9 / max(1, n_genes * 4)))
        batch_cells = max(chunksize, (target // chunksize) * chunksize)
    else:
        batch_cells = max(chunksize, (batch_cells // chunksize) * chunksize)
    batch_cells = min(batch_cells, ((n_cells + chunksize - 1) // chunksize) * chunksize)

    # every local device participates by default: shard each device batch
    # over a 1-D cell mesh (the counterpart of the reference's process pool,
    # reference: tl/_infercnv.py:120-135)
    use_mesh = mesh is not False and (mesh is not None or len(jax.devices()) > 1)
    n_dev = 1
    # device-side densification: sparse single-device input ships the CSR
    # arrays and packs on the accelerator (replaces the reference's host
    # densify, reference: tl/_infercnv.py:115-137)
    use_sparse = device_densify is not False and sp.issparse(expr) and not use_mesh
    if device_densify and use_mesh:
        warn("device_densify is not supported with a multi-device mesh; using the host packer")
    # compressed result fetch: bitmask + compacted survivors instead of the
    # dense matrix (the noise gate zeroes most entries — see
    # ops/result_pack.py).  On a mesh the
    # compaction runs per shard under shard_map (no cross-device cumsum).
    use_result_pack = compress_results is True or (
        compress_results is None and dynamic_threshold is not None
    )
    data_sh = repl_sh = the_mesh = None
    if use_mesh:
        from ..parallel.mesh import cell_mesh, replicate, shard_cells

        the_mesh = mesh if mesh is not None else cell_mesh()
        n_dev = int(the_mesh.devices.size)
        data_sh, repl_sh = shard_cells(the_mesh), replicate(the_mesh)

    # transform construction is LAZY: a run whose every batch resumes from a
    # complete checkpoint never builds (let alone compiles) a kernel
    _fn_cache: list = []

    def _get_fn():
        if not _fn_cache:
            if use_mesh:
                from ..parallel.sharded import sharded_infercnv_fn

                _fn_cache.append(
                    sharded_infercnv_fn(
                        plan,
                        the_mesh,
                        n_ref_rows=reference.shape[0],
                        lfc_clip=lfc_clip,
                        dynamic_threshold=dynamic_threshold,
                        num_chunks=num_chunks,
                        calculate_gene_values=calculate_gene_values,
                        dtype=cdtype,
                    )
                )
            else:
                _fn_cache.append(
                    build_infercnv_fn(
                        plan,
                        n_ref_rows=reference.shape[0],
                        lfc_clip=lfc_clip,
                        dynamic_threshold=dynamic_threshold,
                        num_chunks=num_chunks,
                        calculate_gene_values=calculate_gene_values,
                        dtype=cdtype,
                    )
                )
        return _fn_cache[0]

    _LAST_RUN_INFO.clear()
    _LAST_RUN_INFO.update({"n_devices": n_dev, "sharded": use_mesh, "device_densify": use_sparse})

    ckpt = None
    if checkpoint_dir is not None:
        import json
        from pathlib import Path

        ckpt = Path(checkpoint_dir)
        ckpt.mkdir(parents=True, exist_ok=True)
        fp = _ckpt_fingerprint(
            expr, var, reference, n_cells, n_genes, window_size, step, lfc_clip, dynamic_threshold,
            chunksize, calculate_gene_values, batch_cells, cdtype, tdt,
        )
        manifest = ckpt / "manifest.json"
        if manifest.exists():
            if json.loads(manifest.read_text()).get("fingerprint") != fp:
                raise ValueError(
                    f"checkpoint_dir {str(ckpt)!r} holds results for a DIFFERENT configuration "
                    "(data, reference, or parameters changed) — clear it or pick another directory."
                )
        else:
            tmp = manifest.with_suffix(".json.tmp")
            tmp.write_text(json.dumps({"fingerprint": fp, "n_cells": n_cells, "batch_cells": batch_cells}))
            tmp.replace(manifest)

    # host-side packing: genes land in the plan's packed layout during
    # densification, so the device never pays for the permutation gather
    lut = _pack_lut(plan, n_genes)
    width = packed_width(plan)
    ref_dev = pack_columns(np.asarray(reference, dtype=cdtype), plan, lut)
    if use_mesh:
        ref_dev = jax.device_put(ref_dev, repl_sh)
    res_parts = []
    gene_parts = [] if calculate_gene_values else None
    n_gene_cols = None
    if calculate_gene_values:
        n_gene_cols = int(gene_projection_data(plan).total)

    timing = stats is not None

    def _tick():
        return _time.perf_counter() if timing else 0.0

    def _tock(key, t0):
        if timing:
            stats[key] = stats.get(key, 0.0) + (_time.perf_counter() - t0)

    def _fetch(payload, rows):
        """Device payload -> host tuple (same kind tag, numpy buffers);
        dense payloads slice to the real rows so byte accounting matches."""
        kind = payload[0]
        if kind in ("packed", "packed_mesh"):
            _, mask_dev, vals_dev, nnz_val = payload
            mask_np = np.asarray(mask_dev)
            vals_np = np.asarray(vals_dev)
            return (kind, mask_np, vals_np, nnz_val), mask_np.nbytes + vals_np.nbytes
        arr = np.asarray(payload[1])[:rows]
        return (kind, arr), arr.nbytes

    def _to_csr(fetched, n_cols, rows):
        """Host payload -> (rows, n_cols) CSR of the result matrix."""
        kind = fetched[0]
        if kind == "packed_mesh":
            from ..ops.result_pack import sharded_mask_vals_to_csr

            return sharded_mask_vals_to_csr(fetched[1], fetched[2], fetched[3], n_cols)[:rows]
        if kind == "packed":
            from ..ops.result_pack import mask_vals_to_csr

            return mask_vals_to_csr(fetched[1], fetched[2][: fetched[3]], n_cols)[:rows]
        return _dense_to_csr(fetched[1])

    def _materialize(pending):
        x_payload, g_payload, rows, start = pending
        t0 = _tick()
        fx, x_bytes = _fetch(x_payload, rows)
        fg = None
        g_bytes = 0
        if g_payload is not None:
            fg, g_bytes = _fetch(g_payload, rows)
        if timing:
            stats["d2h_bytes"] = stats.get("d2h_bytes", 0) + x_bytes + g_bytes
        _tock("d2h_sec", t0)
        t0 = _tick()
        mat = _to_csr(fx, plan.n_windows, rows)
        res_parts.append(mat)
        g_np = None
        if fg is not None:
            if fg[0] == "dense":
                g_np = fg[1]
            else:
                # per-gene values are consumed (and checkpointed) dense
                g_np = _to_csr(fg, n_gene_cols, rows).toarray()
            gene_parts.append(g_np)
        if ckpt is not None:
            import os as _os

            bf = ckpt / f"batch_{start:010d}.npz"
            tmp = ckpt / f"batch_{start:010d}.npz.tmp"
            payload = {
                "data": mat.data, "indices": mat.indices, "indptr": mat.indptr,
                "shape": np.asarray(mat.shape, np.int64),
            }
            if calculate_gene_values:
                payload["gene"] = g_np
            with open(tmp, "wb") as fh:
                np.savez(fh, **payload)
            _os.replace(tmp, bf)
        _tock("csr_sec", t0)

    def _get_sparse_fn(cap, rows_padded):
        from ..ops.sparse_ingest import build_sparse_infercnv_fn

        # the builder memoizes module-level, so this is cheap on every call
        return build_sparse_infercnv_fn(
            plan,
            n_rows=rows_padded,
            nnz_cap=cap,
            n_ref_rows=reference.shape[0],
            lfc_clip=lfc_clip,
            dynamic_threshold=dynamic_threshold,
            num_chunks=num_chunks,
            calculate_gene_values=calculate_gene_values,
            dtype=cdtype,
        )

    def _run(f, *args):
        """Dispatch ``f`` through the module-level executable cache.

        Every call — timing or not — goes through ONE ahead-of-time-compiled
        executable per (transform, argument signature), shared across driver
        invocations in this process.  That guarantees a run following a
        stats/warmup run with the same configuration is warm (the round-4
        bench showed the jit path recompiling after the AOT stats path had
        already compiled the same program).  With stats enabled, compilation
        is timed separately and the call blocks so compute time is attributed
        exactly.
        """
        compiled, wrap, compile_sec = _compiled_executable(f, args)
        if timing and compile_sec:
            stats["compile_sec"] = stats.get("compile_sec", 0.0) + compile_sec
        t0 = _time.perf_counter() if timing else 0.0
        out = wrap(compiled(*args))
        if timing:
            jax.block_until_ready([o for o in jax.tree.leaves(out) if o is not None])
            stats["compute_sec"] = stats.get("compute_sec", 0.0) + (_time.perf_counter() - t0)
        return out

    if timing:
        stats["mode"] = "device_densify" if use_sparse else ("mesh" if use_mesh else "host_pack")
        if tdt is not None:
            stats["transfer_dtype"] = str(tdt)
        stats["result_pack"] = use_result_pack

    # one nnz capacity for ALL batches of this run (the per-batch maximum,
    # bucket-rounded) so every batch hits the same compiled executable
    shared_cap = None
    if use_sparse and hasattr(expr, "indptr"):
        from ..ops.sparse_ingest import round_nnz_cap

        ptr = expr.indptr
        batch_nnz = [
            int(ptr[min(s + batch_cells, n_cells)] - ptr[s]) for s in range(0, n_cells, batch_cells)
        ]
        shared_cap = round_nnz_cap(max(batch_nnz))

    if use_sparse:
        from ..ops.sparse_ingest import coo_from_csr_batch, round_nnz_cap

    def _prepare(start):
        """Host half of one batch: pack + enqueue the device transfer."""
        stop = min(start + batch_cells, n_cells)
        raw = expr[start:stop]
        rows = stop - start
        pad = batch_cells - rows if (n_cells > batch_cells) else 0
        # the cell axis must split evenly over the mesh
        pad += (-(rows + pad)) % n_dev
        rows_padded = rows + pad

        t0 = _tick()
        cap = None
        if use_sparse:
            cap = shared_cap if shared_cap is not None else round_nnz_cap(raw.nnz)
            cols, vals, counts, _nnz = coo_from_csr_batch(
                raw, lut, width, cap, val_dtype=tdt if tdt is not None else np.dtype(cdtype)
            )
            if pad:
                counts = np.concatenate([counts, np.zeros(pad, np.int32)])
            operands = (cols, vals, counts)
            h2d_bytes = cols.nbytes + vals.nbytes + counts.nbytes
        else:
            if sp.issparse(raw):
                block = pack_csr(raw, plan, lut, dtype=cdtype)
            else:
                block = pack_columns(_ensure_array(np.asarray(raw)), plan, lut, dtype=cdtype)
            if tdt is not None:
                # reduced-precision transfer: cast after the (native) pack;
                # the device upcasts back to the compute dtype
                block = block.astype(tdt)
            if pad:
                block = np.vstack([block, np.zeros((pad, width), dtype=block.dtype)])
            operands = (block,)
            h2d_bytes = block.nbytes
        _tock("host_pack_sec", t0)

        chunk_ids = (start + np.arange(rows_padded)) // chunksize
        if pad:
            chunk_ids[rows:] = num_chunks
        chunk_ids = chunk_ids.astype(np.int32)

        t0 = _tick()
        if use_mesh:
            operands = tuple(jax.device_put(o, data_sh) for o in operands)
            chunk_ids = jax.device_put(chunk_ids, data_sh)
        else:
            operands = tuple(jax.device_put(o) for o in operands)
            chunk_ids = jax.device_put(chunk_ids)
        if timing:
            jax.block_until_ready(operands)
            stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + h2d_bytes
        _tock("h2d_sec", t0)
        return operands, chunk_ids, rows, rows_padded, cap

    t_run0 = _time.perf_counter()

    def _progress(done):
        if progress is False:
            return
        elapsed = _time.perf_counter() - t_run0
        rate = done / max(elapsed, 1e-9)
        if callable(progress):
            progress({
                "cells_done": done, "cells_total": n_cells, "elapsed_sec": elapsed,
                "cells_per_sec": rate, "eta_sec": (n_cells - done) / max(rate, 1e-9),
            })
        else:
            # reference ships a tqdm bar on the chunk map (reference:
            # tl/_infercnv.py:131); here a verbosity-gated line per batch
            msg = (
                f"infercnv: {done:,}/{n_cells:,} cells "
                f"({rate:,.0f} cells/s, ETA {(n_cells - done) / max(rate, 1e-9):.0f}s)"
            )
            if progress is True:
                import sys as _sys

                print(msg, file=_sys.stderr, flush=True)
            else:
                from .._util import info

                info(msg)

    # software pipeline: while the device computes batch k, a single worker
    # thread packs batch k+1 and enqueues its transfer, and the main thread
    # drains batch k-1 (async device->host copy) — packing, transfers, and
    # compute all overlap (the counterpart of the reference's worker pool
    # keeping all cores busy, reference: tl/_infercnv.py:120-137).  The
    # worker thread matters on backends where `device_put` blocks the calling
    # thread until bytes are on the device.  With stats
    # enabled the pipeline is serialized instead, so the per-stage breakdown
    # is exact and the total is an upper bound on the pipelined wall time.
    starts = list(range(0, n_cells, batch_cells))
    resumed = set()
    if ckpt is not None:
        resumed = {s for s in starts if (ckpt / f"batch_{s:010d}.npz").exists()}
    compute_starts = [s for s in starts if s not in resumed]

    use_prefetch = not timing and len(compute_starts) > 1
    pool = None
    futures: dict = {}
    if use_prefetch:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="infercnv-h2d")
        futures[compute_starts[0]] = pool.submit(_prepare, compute_starts[0])
    next_prefetch = 1

    pack_caps = {"x": 0, "gene": 0}

    def _try_pack(arr, cap_key, rows):
        """Pack one result matrix; None when dense would ship fewer bytes
        (skewed shard survivors / ungated dense results)."""
        from ..ops.result_pack import (
            compact_fn,
            mask_nnz_fn,
            round_result_cap,
            sharded_compact_fn,
            sharded_mask_nnz_fn,
        )

        w = arr.shape[1]
        if use_mesh:
            mask_dev, shard_nnz_dev = _run(sharded_mask_nnz_fn(the_mesh, w), arr, np.int32(rows))
            shard_nnz = np.asarray(shard_nnz_dev)  # tiny fetch sizes capacity
            pack_caps[cap_key] = max(pack_caps[cap_key], round_result_cap(int(shard_nnz.max())))
            cap_b = pack_caps[cap_key]
            if mask_dev.size * 4 + n_dev * cap_b * 4 >= arr.nbytes:
                return None
            vals_dev = _run(sharded_compact_fn(the_mesh, cap_b), arr, np.int32(rows))
            return ("packed_mesh", mask_dev, vals_dev, shard_nnz)
        mask_dev, nnz_dev = _run(mask_nnz_fn(w), arr, np.int32(rows))
        nnz_val = int(nnz_dev)
        pack_caps[cap_key] = max(pack_caps[cap_key], round_result_cap(nnz_val))
        cap_b = pack_caps[cap_key]
        if mask_dev.size * 4 + cap_b * 4 >= arr.nbytes:
            return None
        vals_dev = _run(compact_fn(cap_b), arr, np.int32(rows))
        return ("packed", mask_dev, vals_dev, nnz_val)

    try:
        pending = None
        done_cells = 0
        for start in starts:
            stop = min(start + batch_cells, n_cells)
            if start in resumed:
                # resume: this batch is already on disk.  Drain the pipeline
                # first so parts stay in cell order.
                if pending is not None:
                    _materialize(pending)
                    pending = None
                with np.load(ckpt / f"batch_{start:010d}.npz") as z:
                    res_parts.append(
                        sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
                    )
                    if calculate_gene_values:
                        gene_parts.append(z["gene"])
                done_cells += stop - start
                _progress(done_cells)
                continue
            if use_prefetch:
                operands, chunk_ids, rows, rows_padded, cap = futures.pop(start).result()
                if next_prefetch < len(compute_starts):
                    nxt = compute_starts[next_prefetch]
                    futures[nxt] = pool.submit(_prepare, nxt)
                    next_prefetch += 1
            else:
                operands, chunk_ids, rows, rows_padded, cap = _prepare(start)

            if use_sparse:
                cols_d, vals_d, counts_d = operands
                x_res, gene_res = _run(
                    _get_sparse_fn(cap, rows_padded), cols_d, vals_d, counts_d, ref_dev, chunk_ids
                )
            else:
                x_res, gene_res = _run(_get_fn(), operands[0], ref_dev, chunk_ids)
            x_payload = (_try_pack(x_res, "x", rows) if use_result_pack else None) or ("dense", x_res)
            if calculate_gene_values:
                g_payload = (_try_pack(gene_res, "gene", rows) if use_result_pack else None) or (
                    "dense", gene_res
                )
            else:
                g_payload = None
            for payload in (x_payload, g_payload):
                if payload is None:
                    continue
                for arr in payload[1:3]:
                    if hasattr(arr, "copy_to_host_async"):
                        arr.copy_to_host_async()
            if pending is not None:
                _materialize(pending)
            pending = (x_payload, g_payload, rows, start)
            done_cells += stop - start
            _progress(done_cells)
        if pending is not None:
            _materialize(pending)
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    res = sp.vstack(res_parts) if len(res_parts) > 1 else res_parts[0]
    per_gene = None
    if calculate_gene_values:
        used = np.concatenate(gene_parts, axis=0) if len(gene_parts) > 1 else gene_parts[0]
        # device gene columns are in coverage-group-sorted order; scatter them
        # back to the masked var axis (uncovered genes stay NaN, matching the
        # reference's reindex, reference: tl/_infercnv.py:141-149)
        covered_sorted = gene_projection_data(plan).covered_sorted
        per_gene = np.full((n_cells, var.shape[0]), np.nan, dtype=used.dtype)
        per_gene[:, plan.used_genes[covered_sorted]] = used
    return plan.chr_pos, res, per_gene


def _get_reference(
    adata,
    reference_key: str | None,
    reference_cat,
    reference: np.ndarray | None,
    layer: str | None,
) -> np.ndarray:
    """Reference-baseline extraction (behavior matches reference tl/_infercnv.py:359-408)."""
    if layer is not None:
        X = adata.layers[layer]
    else:
        X = adata.X

    if reference is None:
        if reference_key is None or reference_cat is None:
            warn(
                "No reference given — falling back to the mean over ALL cells as the baseline; "
                "pass `reference` or `reference_key`+`reference_cat` for meaningful CNV calls."
            )
            reference = _mean0(X)
        else:
            labels = np.asarray(adata.obs[reference_key].values)
            cats = np.array([reference_cat] if isinstance(reference_cat, str) else list(reference_cat))
            # error text is observable API surface (reference tl/_infercnv.py:388-392)
            absent = cats[~np.isin(cats, labels)]
            if absent.size:
                raise ValueError(f"Categories {absent} do not occur in `adata.obs[{reference_key!r}]`.")
            reference = np.vstack([_mean0(X[labels == cat, :]) for cat in cats])

    reference = np.asarray(reference)
    if reference.ndim == 1:
        reference = reference[np.newaxis, :]
    if reference.shape[1] != adata.shape[1]:
        raise ValueError("The reference baseline has a different gene count than `adata`.")
    return reference


def _mean0(X) -> np.ndarray:
    """Column means as a 1-D float64 array for dense or sparse input."""
    if sp.issparse(X):
        return np.asarray(X.mean(axis=0)).ravel()
    return np.asarray(np.mean(np.asarray(X), axis=0)).ravel()
