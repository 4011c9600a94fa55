"""The CNV smoothing pipeline as one functional JAX program.

Numerics contract (must match reference tl/_infercnv.py:411-457):

1. center against the reference baseline — single reference: plain difference;
   multiple references: *bounded* logFC (values between the per-gene min/max of
   the category means map to 0) (reference :419-434)
2. clip to ±lfc_clip (reference :435-436)
3. pyramidally-weighted running mean along genomic position, per chromosome,
   every ``step``-th window (reference :179-244,301-343) — here ONE strided
   convolution over the packed gene axis (see genome.plan) + a tiny segment
   mean for small chromosomes
4. per-cell median centering (reference :441-442)
5. noise gating at ``dynamic_threshold × std``, where the std is taken over
   each *chunk* of cells (reference :448-453 computes it per process chunk —
   expressed here as a segmented reduction over ``chunk_ids``, which makes the
   result independent of how cells are batched onto devices)

The device function consumes *pre-packed* input: the host packs genes into the
plan's packed layout while densifying (free for CSR shards — just a column
remap), so the device never pays for the permutation gather.  Use
:func:`pack_columns` / :func:`pack_csr` to produce packed blocks.

The optional per-gene back-projection (reference :247-291, a pure-Python dict
loop) becomes a prefix-sum + two gathers: each gene's value is the mean of the
contiguous range of windows covering it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..genome.plan import WindowPlan, gene_projection_data

__all__ = ["build_infercnv_fn", "smooth_only_fn", "pack_columns", "pack_csr", "packed_width"]


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------


def packed_width(plan: WindowPlan) -> int:
    """Total width of the packed layout: conv region + small-chromosome tail."""
    return plan.packed_len + len(plan.small_src)


def _pack_lut(plan: WindowPlan, n_genes: int) -> np.ndarray:
    """LUT masked-gene-index -> packed column (-1 if the gene is unused).

    The conv region uses a PHASE-MAJOR layout: gene-major packed position
    ``p`` lands at column ``(p % step) * Q + p // step`` with
    ``Q = packed_len // step`` — i.e. the packed axis is stored as its
    ``step`` stride-phases, so the phase conv needs no transpose on device
    (the host pays nothing: it's the same scatter either way).
    """
    lut = np.full(n_genes, -1, dtype=np.int64)
    pos = np.flatnonzero(plan.packed_src >= 0)
    s = plan.step
    Q = plan.packed_len // s
    p = pos
    lut[plan.packed_src[pos]] = (p % s) * Q + p // s
    lut[plan.small_src] = plan.packed_len + np.arange(len(plan.small_src))
    return lut


def pack_columns(
    x: np.ndarray, plan: WindowPlan, lut: np.ndarray | None = None, dtype=None
) -> np.ndarray:
    """Pack a dense (rows × masked_genes) block into the packed layout."""
    if lut is None:
        lut = _pack_lut(plan, x.shape[1])
    out_dtype = np.dtype(dtype) if dtype is not None else np.asarray(x).dtype
    from ..native import native_pack_dense

    res = native_pack_dense(x, lut, packed_width(plan), out_dtype)
    if res is not None:
        return res
    out = np.zeros((x.shape[0], packed_width(plan)), dtype=out_dtype)
    used = lut >= 0
    out[:, lut[used]] = x[:, used]
    return out


def pack_csr(x: sp.spmatrix, plan: WindowPlan, lut: np.ndarray | None = None, dtype=None) -> np.ndarray:
    """Densify a CSR block straight into the packed layout (no intermediate).

    Runs in native C++ when available (one OpenMP-parallel pass over the nnz,
    ~13× the numpy scatter — see native/pack.cpp); numpy fallback otherwise.
    """
    x = x.tocsr()
    if lut is None:
        lut = _pack_lut(plan, x.shape[1])
    out_dtype = np.dtype(dtype) if dtype is not None else np.result_type(x.dtype, np.float32)
    from ..native import native_pack_csr

    res = native_pack_csr(x.indptr, x.indices, x.data, lut, packed_width(plan), out_dtype)
    if res is not None:
        return res
    new_cols = lut[x.indices]
    keep = new_cols >= 0
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))[keep]
    out = np.zeros((x.shape[0], packed_width(plan)), dtype=out_dtype)
    out[rows, new_cols[keep]] = x.data[keep]
    return out


# ---------------------------------------------------------------------------
# Device-side pipeline
# ---------------------------------------------------------------------------


def _center(x, ref):
    """Step 1: reference centering (bounded logFC for multi-category refs)."""
    if ref.shape[0] == 1:
        return x - ref[0][None, :]
    ref_min = jnp.min(ref, axis=0)[None, :]
    ref_max = jnp.max(ref, axis=0)[None, :]
    return jnp.where(x > ref_max, x - ref_max, jnp.where(x < ref_min, x - ref_min, jnp.zeros_like(x)))


def _boxcar_valid(x, width: int):
    """Valid-mode boxcar-sum along the last axis via one cumsum + slice diff."""
    c = jnp.cumsum(x, axis=-1)
    return jnp.concatenate([c[..., width - 1 : width], c[..., width:] - c[..., :-width]], axis=-1)


def _pyramid_conv_cumsum(packed, plan: WindowPlan):
    """Stride-1 valid pyramid conv via two boxcar/cumsum passes.

    Key identity: the pyramidal weights ``min(r, n+1-r)`` are the full
    convolution of two boxcars, ``ones(a) * ones(b)`` with ``a=(n+1)//2``,
    ``b=n+1-a``.  Two cumsum+difference passes replace the O(n) sliding dot
    product — O(1) work per gene.
    """
    n = plan.window_size
    a = (n + 1) // 2
    b = n + 1 - a
    y = _boxcar_valid(_boxcar_valid(packed, a), b)
    return y / jnp.asarray(float(plan.pyramid_sum), dtype=packed.dtype)


def _pyramid_conv_phase(phased, plan: WindowPlan, dtype):
    """Strided pyramid conv on the phase-major layout.

    Only every ``step``-th window is needed, so the packed axis is stored as
    its ``s = step`` stride-phases: ``x3[c, t, q] = gene_major[c, q*s + t]``
    (the host packs this way — no device transpose).  The 1-D window of size
    ``n`` becomes an ``m = ceil(n/s)``-tap convolution over ``q`` with ``s``
    input channels — a dense contraction of size ``m*s >= n`` that XLA hands
    to its convolution library.  Output position ``w`` equals the
    stride-``s`` window at gene-major position ``w*s``.
    """
    n, s = plan.window_size, plan.step
    m = -(-n // s)
    Q = plan.packed_len // s
    pyr = np.zeros(m * s, dtype=np.float64)
    pyr[:n] = plan.pyramid
    kernel = jnp.asarray(pyr.reshape(m, s).T, dtype=dtype)[None, :, :]  # (O=1, I=t, H=u)
    x3 = phased.reshape(phased.shape[0], s, Q)  # N, t, q — already phase-major
    # precision=HIGHEST: a default-precision f32 conv may run in TF32 on the
    # GPU's tensor cores (~1e-3 error — unacceptable for reference parity)
    y = jax.lax.conv_general_dilated(
        x3,
        kernel,
        (1,),
        "VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )[:, 0, :]
    return y  # (N, Q - m + 1): y[:, p] = strided window at gene-major p*s


def _unphase(phased, plan: WindowPlan):
    """Phase-major conv region -> gene-major (for the cross-check conv paths)."""
    s = plan.step
    Q = plan.packed_len // s
    return phased.reshape(phased.shape[0], s, Q).transpose(0, 2, 1).reshape(phased.shape[0], s * Q)


def _smooth_packed(xc, plan: WindowPlan, dtype, mode: str):
    """Step 3 on packed input (phase-major conv region + small tail).

    mode="phase" / "cumsum": the two production formulations.
    mode="conv": direct strided XLA convolution (cross-check path).
    """
    if mode not in ("phase", "cumsum", "conv"):
        raise ValueError(f"unknown smoothing mode {mode!r}")
    parts = []
    if plan.n_reg_windows:
        region = xc[:, : plan.packed_len]
        if mode == "conv":
            kernel = jnp.asarray(plan.pyramid, dtype=dtype)
            y = jax.lax.conv_general_dilated(
                _unphase(region, plan)[:, None, :],
                kernel[None, None, :],
                window_strides=(plan.step,),
                padding="VALID",
                dimension_numbers=("NCH", "OIH", "NCH"),
            )[:, 0, :]
            parts.append(y[:, jnp.asarray(plan.conv_gather)])
        elif mode == "phase":
            y = _pyramid_conv_phase(region, plan, dtype)
            parts.append(y[:, jnp.asarray(plan.conv_gather)])
        else:
            y = _pyramid_conv_cumsum(_unphase(region, plan), plan)
            parts.append(y[:, jnp.asarray(plan.conv_gather * plan.step)])
    if plan.n_small:
        xs = xc[:, plan.packed_len : plan.packed_len + len(plan.small_src)]
        seg_sum = jax.ops.segment_sum(xs.T, jnp.asarray(plan.small_seg), num_segments=plan.n_small)
        counts = jnp.asarray(plan.small_counts, dtype=dtype)
        parts.append((seg_sum / counts[:, None]).T)
    concat = jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    return concat[:, jnp.asarray(plan.final_src)]


def _gene_values(smoothed, plan: WindowPlan, dtype):
    """Back-projection: gene value = mean of the covering (contiguous) windows."""
    lo = jnp.asarray(plan.gene_win_lo)
    hi = jnp.asarray(plan.gene_win_hi)
    prefix = jnp.concatenate(
        [jnp.zeros((smoothed.shape[0], 1), dtype=smoothed.dtype), jnp.cumsum(smoothed, axis=1)], axis=1
    )
    counts = (hi - lo + 1).astype(dtype)
    vals = (prefix[:, hi + 1] - prefix[:, jnp.maximum(lo, 0)]) / counts[None, :]
    return jnp.where(lo[None, :] >= 0, vals, jnp.nan)


#: Largest phase-conv tap count (``ceil(window / step)``) at which the GPU
#: takes the phase formulation.  Measured on an H100 80GB HBM3 at a 400 W
#: power limit, 16,384 cells: 10 taps (step 10, 19,200 packed columns) phase
#: 5.9 ms vs cumsum 10.6 ms; 100 taps (step 1, 3,862 columns) phase 7.7 ms
#: vs cumsum 1.4 ms.
_PHASE_MAX_TAPS = 10


def smooth_formulation(plan: WindowPlan) -> str:
    """The smoothing formulation for ``plan`` on the default JAX backend.

    The CPU runs the reference cumsum formulation; the GPU picks by tap count
    (see ``_PHASE_MAX_TAPS``).  Any other platform raises instead of guessing.
    """
    backend = jax.default_backend()
    if backend == "cpu":
        return "cumsum"
    if backend == "gpu":
        return "phase" if -(-plan.window_size // plan.step) <= _PHASE_MAX_TAPS else "cumsum"
    raise RuntimeError(f"infercnv has no code path for JAX platform {backend!r} (supported: cpu, gpu)")


def row_median(a):
    """Exact per-row median of a 2-D array (``np.median`` semantics)."""
    return jnp.median(a, axis=1)


#: memoized built transforms — reusing the SAME jit object across driver calls
#: is what makes repeat runs warm (a fresh jit fn would retrace and recompile)
_BUILD_CACHE: dict = {}


def build_infercnv_fn(
    plan: WindowPlan,
    *,
    n_ref_rows: int,
    lfc_clip: float,
    dynamic_threshold: float | None,
    num_chunks: int,
    calculate_gene_values: bool = False,
    dtype=jnp.float32,
    smooth_mode: str | None = None,
    axis_name: str | None = None,
):
    """Build the jitted end-to-end transform over PACKED input.

    Returns ``fn(x_packed, ref_packed, chunk_ids) -> (x_res, gene_res)``:

    * ``x_packed``   — (cells, packed_width(plan)) dense packed expression
      (see :func:`pack_columns` / :func:`pack_csr`)
    * ``ref_packed`` — (n_ref_rows, packed_width(plan)) packed baseline(s)
    * ``chunk_ids``  — (cells,) int32; cells with the same id share a noise-
      gate std (reference chunk semantics).  Ids must lie in ``[0, num_chunks]``
      — id == num_chunks marks padding rows, which receive a threshold from an
      unused segment and must be discarded by the caller.
    * ``gene_res``   — (cells, n_covered_genes) or None; column ``c`` is
      used-gene ``gene_projection_data(plan).covered_sorted[c]`` (uncovered
      genes are omitted; the caller NaN-fills them during the var reindex,
      matching reference tl/_infercnv.py:141-149).
    * ``smooth_mode`` — ``None`` takes the platform's formulation
      (:func:`smooth_formulation`); "phase", "cumsum" or "conv" force one.
    * ``axis_name``  — set when the fn runs inside ``shard_map`` over a cell-
      sharded mesh axis: the per-chunk noise statistics are psum-ed across
      shards so chunk semantics stay GLOBAL (chunks may cross shards).
    """
    smooth_mode = smooth_mode or smooth_formulation(plan)
    key = (
        "dense", plan.cache_key, n_ref_rows, float(lfc_clip),
        None if dynamic_threshold is None else float(dynamic_threshold),
        num_chunks, calculate_gene_values, str(jnp.dtype(dtype)), smooth_mode, axis_name,
    )
    fn = _BUILD_CACHE.get(key)
    if fn is None:
        fn = _BUILD_CACHE[key] = _build_infercnv_fn_uncached(
            plan, lfc_clip=lfc_clip, dynamic_threshold=dynamic_threshold, num_chunks=num_chunks,
            calculate_gene_values=calculate_gene_values, dtype=dtype, smooth_mode=smooth_mode,
            axis_name=axis_name,
        )
    return fn


def _build_infercnv_fn_uncached(
    plan: WindowPlan,
    *,
    lfc_clip: float,
    dynamic_threshold: float | None,
    num_chunks: int,
    calculate_gene_values: bool,
    dtype,
    smooth_mode: str,
    axis_name: str | None,
):
    if calculate_gene_values:
        covered_sorted = gene_projection_data(plan).covered_sorted

    @jax.jit
    def fn(x, ref, chunk_ids):
        x = x.astype(dtype)
        ref = ref.astype(dtype)
        xc = _center(x, ref)
        xc = jnp.clip(xc, -lfc_clip, lfc_clip)
        smoothed = _smooth_packed(xc, plan, dtype, smooth_mode)
        med = row_median(smoothed)
        x_res = smoothed - med[:, None]

        gene_res = None
        if calculate_gene_values:
            gvals = _gene_values(smoothed, plan, dtype)[:, jnp.asarray(covered_sorted)]
            gmed = row_median(gvals)
            gene_res = gvals - gmed[:, None]

        if dynamic_threshold is not None:
            n_win = x_res.shape[1]
            seg_sum = jax.ops.segment_sum(jnp.sum(x_res, axis=1), chunk_ids, num_segments=num_chunks + 1)
            seg_sq = jax.ops.segment_sum(jnp.sum(x_res * x_res, axis=1), chunk_ids, num_segments=num_chunks + 1)
            seg_n = jax.ops.segment_sum(
                jnp.full(x_res.shape[0], n_win, dtype=dtype), chunk_ids, num_segments=num_chunks + 1
            )
            if axis_name is not None:
                seg_sum = jax.lax.psum(seg_sum, axis_name)
                seg_sq = jax.lax.psum(seg_sq, axis_name)
                seg_n = jax.lax.psum(seg_n, axis_name)
            seg_n = jnp.maximum(seg_n, 1)
            mean = seg_sum / seg_n
            var = jnp.maximum(seg_sq / seg_n - mean * mean, 0)
            thr = dynamic_threshold * jnp.sqrt(var)
            row_thr = thr[chunk_ids][:, None]
            x_res = jnp.where(jnp.abs(x_res) < row_thr, jnp.zeros_like(x_res), x_res)
            if gene_res is not None:
                gene_res = jnp.where(jnp.abs(gene_res) < row_thr, jnp.zeros_like(gene_res), gene_res)

        return x_res, gene_res

    return fn


def smooth_only_fn(plan: WindowPlan, dtype=jnp.float32, mode: str | None = None):
    """Jitted smoothing-only transform on UNPACKED input (tests/benchmarks)."""

    def fn(xc):
        xc = np.asarray(xc)
        xp = pack_columns(xc, plan, _pack_lut(plan, xc.shape[1]))
        return _smooth_jit(plan, dtype, mode or smooth_formulation(plan))(jnp.asarray(xp))

    return fn


_smooth_cache = {}


def _smooth_jit(plan: WindowPlan, dtype, mode):
    key = (id(plan), np.dtype(dtype).name, mode)
    if key not in _smooth_cache:

        @jax.jit
        def fn(xp):
            return _smooth_packed(xp.astype(dtype), plan, dtype, mode)

        _smooth_cache[key] = fn
    return _smooth_cache[key]
