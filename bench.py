#!/usr/bin/env python
"""Benchmark the infercnv pipeline on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Baseline: the reference (icbi-lab/infercnvpy) runs 183 cells x ~5.9k stride-1
windows x 100-wide pyramid windows in 462 ms on CPU — ~2.3e8 cell-gene-window
ops/s effective (BASELINE.md).  vs_baseline = our ops/s / 2.3e8.

Method: input data is generated on the device; each timed call of the
jitted step ends in ``block_until_ready``; the per-call time is the median
of the timed calls after one warm-up call.  Exits non-zero when JAX finds
no GPU or when any section fails (the failure is recorded in the JSON).
"""

import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 1)[0])

import numpy as np
import pandas as pd

BASELINE_OPS_PER_SEC = 2.3e8  # reference CPU effective rate (BASELINE.md)


def _make_var(n_genes: int, seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    sizes = np.array([248, 242, 198, 190, 181, 171, 159, 145, 138, 134, 135, 133,
                      114, 107, 102, 90, 83, 80, 59, 64, 47, 51], dtype=float)
    counts = np.maximum(1, (sizes / sizes.sum() * n_genes)).astype(int)
    counts[0] += n_genes - counts.sum()
    rows = []
    for c, k in enumerate(counts):
        starts = np.sort(rng.integers(1, int(sizes[c] * 1e6), size=k))
        for s in starts:
            rows.append((f"chr{c + 1}", int(s)))
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1000
    return var


def main():
    T_START = time.perf_counter()
    import jax
    import jax.numpy as jnp

    from chip_smoke import card_line, require_gpu
    from infercnvpy_tpu.genome import build_window_plan
    from infercnvpy_tpu.ops.infercnv_kernel import build_infercnv_fn, packed_width

    devices = require_gpu()

    n_cells = int(float(sys.argv[1])) if len(sys.argv) > 1 else 16384
    n_genes = int(float(sys.argv[2])) if len(sys.argv) > 2 else 20000
    window, step = 100, 10

    var = _make_var(n_genes)
    plan = build_window_plan(var, window, step)
    width = packed_width(plan)
    chunksize = 5000
    num_chunks = -(-n_cells // chunksize)

    base = build_infercnv_fn(
        plan,
        n_ref_rows=2,
        lfc_clip=3.0,
        dynamic_threshold=1.5,
        num_chunks=num_chunks,
        dtype=jnp.float32,
    )

    key = jax.random.PRNGKey(0)
    kx, kr = jax.random.split(key)
    x = jax.random.normal(kx, (n_cells, width), dtype=jnp.float32)
    ref0 = jax.random.normal(kr, (2, width), dtype=jnp.float32)
    chunk_ids = (jnp.arange(n_cells, dtype=jnp.int32) // chunksize).astype(jnp.int32)

    def note(msg):
        print(f"[bench +{time.perf_counter() - T_START:.0f}s] {msg}", file=sys.stderr, flush=True)

    def sec_per_call(fn, reps):
        """Median wall time of ``reps`` device-resident calls, each ended by block_until_ready."""
        jax.block_until_ready(fn(x, ref0, chunk_ids))  # compile + warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(x, ref0, chunk_ids))
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    dt = sec_per_call(base, 50)
    note("default-mode step timed")

    gene_fn = build_infercnv_fn(
        plan,
        n_ref_rows=2,
        lfc_clip=3.0,
        dynamic_threshold=1.5,
        num_chunks=num_chunks,
        calculate_gene_values=True,
        dtype=jnp.float32,
    )
    gene_dt = sec_per_call(gene_fn, 20)
    note("gene-values mode timed")

    # --- end-to-end: CSR AnnData-style input -> device -> CSR out.
    # Default path ships the CSR arrays and densifies ON DEVICE
    # (ops/sparse_ingest.py); device_densify=False measures the legacy
    # host-pack path for comparison.  Stats mode serializes the pipeline, so
    # each stage (host remap / h2d transfer / compute / d2h / csr assembly /
    # compile) is attributed exactly; the reported total excludes compile.
    import resource

    import scipy.sparse as s_sp

    from infercnvpy_tpu.tl._infercnv import _infercnv_compute

    def make_csr(n_cells_e2e, density):
        rng = np.random.default_rng(1)
        nnz_per_row = max(1, int(n_genes * density))
        indptr = np.arange(n_cells_e2e + 1, dtype=np.int64) * nnz_per_row
        indices = rng.integers(0, n_genes, size=n_cells_e2e * nnz_per_row, dtype=np.int32)
        data = rng.normal(size=n_cells_e2e * nnz_per_row).astype(np.float32) ** 2
        expr = s_sp.csr_matrix((data, indices, indptr), shape=(n_cells_e2e, n_genes))
        expr.sum_duplicates()
        return expr

    def e2e(n_cells_e2e, density=0.05, device_densify=None, pipelined=False, transfer_dtype=None):
        """stats mode (default) serializes every stage for exact attribution;
        pipelined=True runs the real software pipeline (pack/H2D/compute/D2H
        overlap) and reports only the wall total — the deliverable number."""
        expr = make_csr(n_cells_e2e, density)
        ref = np.asarray(expr[: min(2000, n_cells_e2e)].mean(axis=0), dtype=np.float64)
        stats = None if pipelined else {}
        t0 = time.perf_counter()
        chr_pos, res, _ = _infercnv_compute(
            expr,
            var,
            ref,
            lfc_clip=3.0,
            window_size=window,
            step=step,
            dynamic_threshold=1.5,
            chunksize=chunksize,
            calculate_gene_values=False,
            batch_cells=None,
            dtype=np.float32,
            device_densify=device_densify,
            stats=stats,
            num_chunk_segments=256,  # shared capacity -> one executable for all sizes
            transfer_dtype=transfer_dtype,
        )
        t_total = time.perf_counter() - t0
        assert res.shape == (n_cells_e2e, plan.n_windows)
        if pipelined:
            # warm by construction: the preceding stats run compiled the same
            # executable into the driver's module-level AOT cache, so this
            # measures the true overlapped pipeline (pack/H2D/compute/D2H)
            out = {
                "n_cells": n_cells_e2e,
                "density": density,
                "mode": "device_densify_pipelined" + ("_bf16" if transfer_dtype else ""),
                "total_sec": float(f"{t_total:.4g}"),
                "cells_per_sec": float(f"{n_cells_e2e / max(t_total, 1e-9):.4g}"),
                "peak_host_rss_gb": float(f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.3g}"),
            }
            del expr, res
            return out
        compile_sec = stats.get("compile_sec", 0.0)
        run_sec = t_total - compile_sec
        h2d = stats.get("h2d_bytes", 0)
        out = {
            "n_cells": n_cells_e2e,
            "density": density,
            "mode": stats.get("mode") + ("_bf16" if stats.get("transfer_dtype") else ""),
            "total_sec": float(f"{run_sec:.4g}"),
            "cells_per_sec": float(f"{n_cells_e2e / max(run_sec, 1e-9):.4g}"),
            "compile_sec": float(f"{compile_sec:.4g}"),
            "stages_sec": {
                k.removesuffix("_sec"): float(f"{stats.get(k, 0.0):.4g}")
                for k in ("host_pack_sec", "h2d_sec", "compute_sec", "d2h_sec", "csr_sec")
            },
            "h2d_bytes": int(h2d),
            "h2d_mbps": float(f"{h2d / max(stats.get('h2d_sec', 0.0), 1e-9) / 1e6:.4g}"),
            "peak_host_rss_gb": float(f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.3g}"),
        }
        del expr, res
        return out

    import os as _os

    E2E_BUDGET_SEC = float(_os.environ.get("BENCH_E2E_BUDGET", "1200"))
    sizes_env = _os.environ.get("BENCH_E2E_SIZES")  # e.g. "1024,4096" for smoke runs
    first, *rest = [int(s) for s in sizes_env.split(",")] if sizes_env else [16384, 102400, 512000, 1024000]
    t_e2e0 = time.perf_counter()

    def e2e_guarded(n_c, label, **kw):
        # one failing size must not cost the whole bench record
        try:
            e2e_results.append(e2e(n_c, **kw))
        except Exception as exc:  # noqa: BLE001 - recorded, not swallowed
            e2e_results.append({"n_cells": n_c, "error": f"{type(exc).__name__}: {exc}"[:300]})
        note(f"e2e {label} done")

    e2e_results = []
    e2e_guarded(first, f"{first} (device_densify)")
    e2e_guarded(first, f"{first} (pipelined)", pipelined=True)
    e2e_guarded(first, f"{first} (host pack)", device_densify=False)
    for i, n_c in enumerate(rest):
        if time.perf_counter() - t_e2e0 > E2E_BUDGET_SEC:
            e2e_results.append({"n_cells": n_c, "skipped": "e2e time budget exhausted"})
            continue
        if n_c >= 512000:
            # large sizes run the production path only — the serialized
            # stats mode would roughly double their wall time and the
            # stage attribution already exists at the smaller sizes
            e2e_guarded(n_c, f"{n_c} (pipelined)", pipelined=True)
            if n_c >= 1000000:
                # with results compressed, the biggest run is input-H2D
                # bound — show the bf16 transfer's effect at full scale
                if time.perf_counter() - t_e2e0 <= E2E_BUDGET_SEC:
                    e2e_guarded(n_c, f"{n_c} (bf16 pipelined)", pipelined=True, transfer_dtype="bfloat16")
                else:
                    e2e_results.append(
                        {"n_cells": n_c, "mode": "device_densify_pipelined_bf16",
                         "skipped": "e2e time budget exhausted"}
                    )
            continue
        e2e_guarded(n_c, str(n_c))
        if i == 0:
            e2e_guarded(n_c, f"{n_c} (pipelined)", pipelined=True)
            # opt-in reduced-precision transfer: ~half the value bytes
            # through the H2D bottleneck (stats run shows the byte cut,
            # pipelined run shows the wall-clock effect)
            e2e_guarded(n_c, f"{n_c} (bf16 stats)", transfer_dtype="bfloat16")
            e2e_guarded(n_c, f"{n_c} (bf16 pipelined)", pipelined=True, transfer_dtype="bfloat16")

    # the reference's own headline benchmark: its tutorial times the
    # 183-cell oligodendroglioma workflow at 462 ms on CPU
    # (reference docs/notebooks/reproduce_infercnv.ipynb).  Measure the warm
    # full-API path on the bundled-dataset stand-in (same shape/semantics).
    try:
        import infercnvpy_tpu as _cnv

        _adata = _cnv.datasets.oligodendroglioma()
        _kw = dict(
            reference_key="cell_type",
            reference_cat=["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"],
            inplace=False,
        )
        _cnv.tl.infercnv(_adata, **_kw)  # compile/warm
        _ts = []
        for _ in range(5):
            _t0 = time.perf_counter()
            _cnv.tl.infercnv(_adata, **_kw)
            _ts.append(time.perf_counter() - _t0)
        small_workflow = {
            "n_cells": int(_adata.shape[0]),
            "warm_sec": float(f"{min(_ts):.4g}"),
            "reference_cpu_sec": 0.462,
            "speedup_vs_reference": float(f"{0.462 / min(_ts):.4g}"),
        }
    except Exception as exc:  # noqa: BLE001 - recorded, not swallowed
        small_workflow = {"error": f"{type(exc).__name__}: {exc}"[:200]}
    note("small-workflow headline timed")

    # the e2e DELIVERABLE is the pipelined production path at the largest
    # size that ran it (stats-mode entries exist for attribution, not as the
    # headline — they serialize the pipeline)
    pipelined = [e for e in e2e_results if "pipelined" in str(e.get("mode", "")) and "cells_per_sec" in e]
    e2e_headline = max(pipelined, key=lambda e: e["n_cells"], default=None)

    ops = n_cells * plan.n_windows * window  # useful cell-gene-window MACs
    ops_per_sec = ops / dt
    result = {
        "metric": "cell_gene_window_ops_per_sec",
        "value": float(f"{ops_per_sec:.4g}"),
        "unit": "ops/s",
        "vs_baseline": float(f"{ops_per_sec / BASELINE_OPS_PER_SEC:.4g}"),
        "detail": {
            "device": {
                "platform": devices[0].platform,
                "kind": devices[0].device_kind,
                "count": len(devices),
                "card": card_line(),
            },
            "n_cells": n_cells,
            "n_genes": n_genes,
            "n_windows": plan.n_windows,
            "window": window,
            "step": step,
            "sec_per_call": float(f"{dt:.6g}"),
            "cells_per_sec": float(f"{n_cells / dt:.4g}"),
            "effective_gbps": float(f"{n_cells * n_genes * 4 / dt / 1e9:.4g}"),
            "gene_values_sec_per_call": float(f"{gene_dt:.6g}"),
            "gene_values_slowdown": float(f"{gene_dt / dt:.3g}"),
            "small_workflow_183c": small_workflow,
            "e2e_headline": e2e_headline,
            "end_to_end_csr": e2e_results,
        },
    }
    print(json.dumps(result))
    failed = "error" in small_workflow or any("error" in e for e in e2e_results)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
