"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The counterpart of the reference's chunking-equivalence test
(reference: tests/test_tools.py:172-191): N-device sharded execution must
reproduce the single-device result exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from infercnvpy_tpu.genome import build_window_plan
from infercnvpy_tpu.ops.infercnv_kernel import _pack_lut, build_infercnv_fn, pack_columns
from infercnvpy_tpu.parallel import cell_mesh, replicate, shard_cells
from infercnvpy_tpu.parallel.sharded import sharded_infercnv_fn


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n_cells, n_genes = 64, 200
    var = pd.DataFrame(
        {
            "chromosome": ["chr1"] * 120 + ["chr2"] * 60 + ["chr3"] * 20,
            "start": list(range(120)) + list(range(60)) + list(range(20)),
        }
    )
    var["end"] = var["start"] + 1
    plan = build_window_plan(var, 15, 4)
    lut = _pack_lut(plan, n_genes)
    x = pack_columns(rng.normal(size=(n_cells, n_genes)).astype(np.float32), plan, lut)
    ref = pack_columns(rng.normal(size=(2, n_genes)).astype(np.float32), plan, lut)
    chunk_ids = (np.arange(n_cells) // 16).astype(np.int32)
    return plan, x, ref, chunk_ids


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_equals_single_device(problem):
    plan, x, ref, chunk_ids = problem
    kwargs = dict(n_ref_rows=2, lfc_clip=3.0, dynamic_threshold=1.5, num_chunks=4, dtype=jnp.float32)

    single = build_infercnv_fn(plan, **kwargs)
    want, _ = single(x, ref, chunk_ids)

    mesh = cell_mesh()
    fn = sharded_infercnv_fn(plan, mesh, **kwargs)
    data, repl = shard_cells(mesh), replicate(mesh)
    got, _ = fn(
        jax.device_put(x, data),
        jax.device_put(ref, repl),
        jax.device_put(chunk_ids, data),
    )
    assert len(got.sharding.device_set) == 8
    npt.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_sharded_chunk_std_crosses_shards(problem):
    """Chunks of 16 cells span 2 shards of 8 — the segment reduction must
    produce chunk-global (not shard-local) thresholds."""
    plan, x, ref, chunk_ids = problem
    kwargs = dict(n_ref_rows=2, lfc_clip=3.0, dynamic_threshold=1.5, num_chunks=4, dtype=jnp.float32)
    single = build_infercnv_fn(plan, **kwargs)
    want, _ = single(x, ref, chunk_ids)

    mesh = cell_mesh()
    sharded = jax.jit(
        build_infercnv_fn(plan, **kwargs),
        in_shardings=(NamedSharding(mesh, P("cells")), NamedSharding(mesh, P()), NamedSharding(mesh, P("cells"))),
        out_shardings=(NamedSharding(mesh, P("cells")), None),
    )
    got, _ = sharded(x, ref, chunk_ids)
    npt.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    # sanity: gating actually fired (zeros exist) and thresholds differ by chunk
    assert (np.asarray(got) == 0).any()


def _make_adata(n_cells=48, seed=0):
    import infercnvpy_tpu as cnv

    rng = np.random.default_rng(seed)
    var = pd.DataFrame(
        {
            "chromosome": ["chr1"] * 120 + ["chr2"] * 60 + ["chr3"] * 20,
            "start": list(range(120)) + list(range(60)) + list(range(20)),
        }
    )
    var["end"] = var["start"] + 1
    var.index = pd.Index([f"g{i}" for i in range(len(var))])
    X = rng.normal(size=(n_cells, len(var))).astype(np.float32)
    obs = pd.DataFrame({"grp": ["ref" if i % 3 == 0 else "q" for i in range(n_cells)]})
    return cnv.AnnData(X=X, obs=obs, var=var)


def test_public_api_uses_all_devices():
    """`tl.infercnv` must shard over every local device without manual
    plumbing (reference contract: tl/_infercnv.py:18) and reproduce the
    single-device result."""
    import infercnvpy_tpu as cnv
    from infercnvpy_tpu.tl._infercnv import _LAST_RUN_INFO

    adata = _make_adata()
    pos_m, res_m, _ = cnv.tl.infercnv(
        adata, reference_key="grp", reference_cat="ref", window_size=15, step=4, chunksize=16, inplace=False
    )
    assert _LAST_RUN_INFO == {"n_devices": 8, "sharded": True, "device_densify": False}

    pos_s, res_s, _ = cnv.tl.infercnv(
        adata, reference_key="grp", reference_cat="ref", window_size=15, step=4, chunksize=16,
        inplace=False, mesh=False,
    )
    assert _LAST_RUN_INFO == {"n_devices": 1, "sharded": False, "device_densify": False}
    assert pos_m == pos_s
    npt.assert_allclose(res_m.toarray(), res_s.toarray(), rtol=1e-6, atol=1e-7)


def test_public_api_mesh_gene_values():
    import infercnvpy_tpu as cnv

    adata = _make_adata(n_cells=24, seed=1)
    _, res_m, gene_m = cnv.tl.infercnv(
        adata, reference_key="grp", reference_cat="ref", window_size=15, step=4, chunksize=7,
        calculate_gene_values=True, inplace=False,
    )
    _, res_s, gene_s = cnv.tl.infercnv(
        adata, reference_key="grp", reference_cat="ref", window_size=15, step=4, chunksize=7,
        calculate_gene_values=True, inplace=False, mesh=False,
    )
    npt.assert_allclose(res_m.toarray(), res_s.toarray(), rtol=1e-6, atol=1e-7)
    npt.assert_array_equal(np.isnan(gene_m), np.isnan(gene_s))
    m = ~np.isnan(gene_s)
    npt.assert_allclose(gene_m[m], gene_s[m], rtol=1e-6, atol=1e-7)


def test_dryrun_multichip_entrypoint():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).parent.parent / "__graft_entry__.py"
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out, gene = fn(*args)
    assert out.shape[0] == args[0].shape[0]
    mod.dryrun_multichip(8)
