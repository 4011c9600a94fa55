"""Device-side CSR densification: ship sparse arrays, pack on the device.

The reference densifies sparse expression on the host, one worker chunk at a
time (reference: tl/_infercnv.py:115-137,419).  The host packer keeps that
shape — host-side densify into the packed layout, then a dense host→device
transfer of ``cells × packed_width × 4`` bytes per batch.  At
typical single-cell densities (2–10 %) that ships 10–20× more bytes than the
CSR arrays contain, and the host scatter is CPU-bound.

This module inverts it: the host only *remaps* CSR column indices through the
packed-layout LUT (a vectorized numpy gather over the nnz) and ships three
flat arrays — column ids (uint16 when the packed width allows), values, and
per-row counts.  The device reconstructs row ids with a prefix-length
``repeat``, forms flat scatter indices, and densifies with one scatter-add
into the zero-initialized packed block — all inside the same jitted program
as the smoothing kernel, so the dense matrix never exists on the host.

Numerics: the scatter-add writes each (row, packed column) at most once for
canonical CSR input, so the densified block is bit-identical to the host
packer's output.  Padding entries carry value 0 and therefore cannot perturb
any column.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..genome.plan import WindowPlan
from .infercnv_kernel import build_infercnv_fn, packed_width

__all__ = ["coo_from_csr_batch", "build_sparse_infercnv_fn", "col_index_dtype", "round_nnz_cap"]

#: nnz capacities are rounded up to a multiple of this so that consecutive
#: batches of similar density reuse one compiled executable
_NNZ_BUCKET = 1 << 20


def col_index_dtype(width: int):
    """Smallest integer dtype that can hold a packed column index."""
    return np.uint16 if width <= (1 << 16) else np.int32


def round_nnz_cap(nnz: int) -> int:
    """Round an nnz count up to the compile-cache bucket size."""
    return max(_NNZ_BUCKET, ((nnz + _NNZ_BUCKET - 1) // _NNZ_BUCKET) * _NNZ_BUCKET)


def coo_from_csr_batch(
    x: sp.spmatrix,
    lut: np.ndarray,
    width: int,
    nnz_cap: int | None = None,
    val_dtype=np.float32,
):
    """Host half of the sparse ingest: CSR batch -> flat transfer arrays.

    Returns ``(cols, vals, counts, nnz_kept)``:

    * ``cols``   — (nnz_cap,) packed column per kept nonzero, padded with
      ``width - 1`` (pad values are 0, so the device scatter-add is a no-op)
    * ``vals``   — (nnz_cap,) matching values, zero-padded
    * ``counts`` — (n_rows,) int32 kept-nonzeros per row
    """
    x = x.tocsr()
    n_rows = x.shape[0]

    # native one-pass remap+compact (OpenMP over rows; bf16 conversion fused
    # into the write pass) — numpy fallback below when the lib is unavailable
    if np.dtype(x.data.dtype) == np.float32:
        from ..native import native_coo_remap

        cdt_n = col_index_dtype(width)
        cap_n = nnz_cap if nnz_cap is not None else int(x.nnz)
        res = native_coo_remap(x.indptr, x.indices, x.data, lut, cap_n, cdt_n, np.dtype(val_dtype))
        if res is not None:
            cols, vals, counts, nnz = res
            cols[nnz:] = width - 1
            vals[nnz:] = 0
            if nnz_cap is None:
                cols, vals = cols[:nnz], vals[:nnz]
            return cols, vals, counts, nnz

    new_cols = lut[x.indices]
    row_nnz = np.diff(x.indptr)
    keep = new_cols >= 0
    if keep.all():
        counts = row_nnz.astype(np.int32)
        kept_cols = new_cols
        kept_vals = x.data
    else:
        rows_rep = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
        counts = np.bincount(rows_rep[keep], minlength=n_rows).astype(np.int32)
        kept_cols = new_cols[keep]
        kept_vals = x.data[keep]
    nnz = len(kept_cols)
    cap = nnz_cap if nnz_cap is not None else nnz
    if nnz > cap:
        raise ValueError(f"nnz_cap {cap} too small for batch with {nnz} kept nonzeros")
    cdt = col_index_dtype(width)
    cols = np.full(cap, width - 1, dtype=cdt)
    vals = np.zeros(cap, dtype=val_dtype)
    cols[:nnz] = kept_cols.astype(cdt)
    vals[:nnz] = kept_vals
    return cols, vals, counts, nnz


#: memoized built transforms (same rationale as infercnv_kernel._BUILD_CACHE:
#: a fresh jit object per driver call would recompile on every run)
_BUILD_CACHE: dict = {}


def build_sparse_infercnv_fn(
    plan: WindowPlan,
    *,
    n_rows: int,
    nnz_cap: int,
    n_ref_rows: int,
    lfc_clip: float,
    dynamic_threshold: float | None,
    num_chunks: int,
    calculate_gene_values: bool = False,
    dtype=None,
):
    """Jitted transform over the flat sparse transfer arrays.

    ``fn(cols, vals, counts, ref_packed, chunk_ids) -> (x_res, gene_res)`` —
    same output contract as :func:`build_infercnv_fn`, but the input is the
    CSR batch from :func:`coo_from_csr_batch` instead of a packed dense block.
    """
    import jax
    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.float32

    key = (
        plan.cache_key, n_rows, nnz_cap, n_ref_rows, float(lfc_clip),
        None if dynamic_threshold is None else float(dynamic_threshold),
        num_chunks, calculate_gene_values, str(jnp.dtype(dtype)), jax.default_backend(),
    )
    cached = _BUILD_CACHE.get(key)
    if cached is not None:
        return cached
    width = packed_width(plan)
    if n_rows * width >= (1 << 31):
        raise ValueError(
            f"batch of {n_rows} rows x packed width {width} overflows int32 flat "
            "indices - lower batch_cells"
        )

    base = build_infercnv_fn(
        plan,
        n_ref_rows=n_ref_rows,
        lfc_clip=lfc_clip,
        dynamic_threshold=dynamic_threshold,
        num_chunks=num_chunks,
        calculate_gene_values=calculate_gene_values,
        dtype=dtype,
    )

    @jax.jit
    def fn(cols, vals, counts, ref, chunk_ids):
        # rebuild row ids from the per-row counts; total_repeat_length pads by
        # repeating the LAST row id, and pad entries carry value 0, so they
        # scatter-add nothing
        row_ids = jnp.repeat(jnp.arange(n_rows, dtype=jnp.int32), counts, total_repeat_length=nnz_cap)
        flat = row_ids * jnp.int32(width) + cols.astype(jnp.int32)
        dense = jnp.zeros((n_rows * width,), dtype).at[flat].add(vals.astype(dtype)).reshape(n_rows, width)
        return base(dense, ref, chunk_ids)

    _BUILD_CACHE[key] = fn
    return fn
