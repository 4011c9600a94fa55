"""Child process for the multi-process (jax.distributed) equivalence test.

Launched by tests/test_distributed.py as::

    python _distributed_child.py <coordinator_port> <process_id> <num_processes> <out_dir>

Each process is one "host": it owns a horizontal slice of the cell axis,
packs it locally, assembles the global cell-sharded array via
``parallel.distributed.infercnv_global_array``, runs the shard-mapped
pipeline over the global mesh, and checks its addressable shards against the
locally-computed single-process reference result.  This is the executed
analogue of the reference's process-pool fan-out
(reference: tl/_infercnv.py:120-137), with the gather replaced by a global
jax.Array and the chunk noise statistics by cross-process psums.
"""

import os
import sys

port, pid, nproc, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"

import jax

jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nproc,
    process_id=pid,
)

import jax.numpy as jnp
import numpy as np
import pandas as pd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from infercnvpy_tpu.genome import build_window_plan
from infercnvpy_tpu.ops.infercnv_kernel import _pack_lut, build_infercnv_fn, pack_csr
from infercnvpy_tpu.parallel.distributed import global_cell_mesh, infercnv_global_array
from infercnvpy_tpu.parallel.sharded import sharded_infercnv_fn

assert jax.process_count() == nproc, jax.process_count()
n_global_dev = len(jax.devices())
assert n_global_dev == 2 * nproc, n_global_dev

# --- deterministic synthetic problem, identical in every process
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

import scipy.sparse as sp

x_csr = sp.random(n_cells, n_genes, density=0.3, format="csr", dtype=np.float32, random_state=1)
ref = rng.normal(size=(2, n_genes)).astype(np.float32)
# chunksize 24 is NOT aligned to the 16-row process shards: chunks cross both
# device and process boundaries, exercising the psum-ed noise statistics
chunk_ids_global = (np.arange(n_cells) // 24).astype(np.int32)
num_chunks = 3

# --- this host's slice: contiguous rows in process order
rows_per_proc = n_cells // nproc
lo, hi = pid * rows_per_proc, (pid + 1) * rows_per_proc
local_packed = pack_csr(x_csr[lo:hi], plan, lut, dtype=np.float32)

from infercnvpy_tpu.ops.infercnv_kernel import pack_columns

ref_packed = pack_columns(ref, plan, lut, dtype=np.float32)

mesh = global_cell_mesh()
assert mesh.devices.size == n_global_dev

x_global = infercnv_global_array(local_packed, mesh)
assert x_global.shape == (n_cells, local_packed.shape[1])

cid_global = infercnv_global_array(chunk_ids_global[lo:hi], mesh)

fn = sharded_infercnv_fn(
    plan,
    mesh,
    n_ref_rows=2,
    lfc_clip=3.0,
    dynamic_threshold=1.5,
    num_chunks=num_chunks,
    dtype=jnp.float32,
)
from jax.sharding import NamedSharding, PartitionSpec as P

ref_dev = jax.device_put(ref_packed, NamedSharding(mesh, P()))
x_res, _ = fn(x_global, ref_dev, cid_global)

# --- reference: full single-process computation (every process can afford it
# at this size; chunk ids are global so the result must match row-for-row)
single_fn = build_infercnv_fn(
    plan, n_ref_rows=2, lfc_clip=3.0, dynamic_threshold=1.5, num_chunks=num_chunks, dtype=jnp.float32
)
want, _ = single_fn(
    jnp.asarray(pack_csr(x_csr, plan, lut, dtype=np.float32)), jnp.asarray(ref_packed), jnp.asarray(chunk_ids_global)
)
want = np.asarray(want)

max_err = 0.0
n_shards = 0
for shard in x_res.addressable_shards:
    got = np.asarray(shard.data)
    sl = shard.index[0]
    max_err = max(max_err, float(np.abs(got - want[sl]).max()))
    n_shards += 1
assert n_shards == 2, n_shards
assert max_err <= 1e-6, max_err

# --- distributed cnv_score: the library's segment-sum + psum collective
# (tl/_scores.py) over the SAME global mesh — per-cluster |CNV| statistics
# reduce across processes and every process receives the replicated result
from infercnvpy_tpu.tl._scores import _sharded_group_abs_fn

n_groups = 4
codes_global = (np.arange(n_cells) % n_groups).astype(np.int32)
codes_dev = infercnv_global_array(codes_global[lo:hi], mesh)
s, c = _sharded_group_abs_fn(mesh, n_groups)(x_res, codes_dev)
score = np.asarray(s)[:n_groups] / np.maximum(np.asarray(c)[:n_groups] * want.shape[1], 1.0)
want_score = np.array([np.abs(want[codes_global == g]).mean() for g in range(n_groups)])
score_err = float(np.abs(score - want_score).max())
assert score_err <= 1e-6, (score, want_score)

with open(os.path.join(out_dir, f"ok_{pid}"), "w") as f:
    f.write(
        f"process {pid}/{nproc}: {n_shards} shards, max_err {max_err:.2e}, "
        f"score_err {score_err:.2e}\n"
    )
print(f"child {pid}: OK (max_err {max_err:.2e}, score_err {score_err:.2e})", flush=True)
