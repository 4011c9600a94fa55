"""infercnvpy_tpu — copy-number-variation inference from scRNA-seq in JAX.

A standalone re-design of the capabilities of infercnvpy (reference:
icbi-lab/infercnvpy) whose compute path is JAX/XLA, run on an NVIDIA GPU
(or the CPU).  Everything runs without scanpy/anndata installed: the package
ships its own lightweight AnnData-compatible container
(:mod:`infercnvpy_tpu.core`) plus device implementations of PCA, kNN graphs,
UMAP and t-SNE and a native Leiden clustering.

Namespace layout mirrors the reference (reference: src/infercnvpy/__init__.py:5-7):
``io`` / ``pp`` / ``tl`` / ``pl`` / ``datasets``.
"""

from . import datasets, io, parallel, pl, pp, tl  # noqa: E402
from .core import AnnData, read_h5ad, write_h5ad  # noqa: E402
from . import profiling, settings  # noqa: E402

settings._auto_enable_compilation_cache()

__all__ = [
    "datasets", "io", "parallel", "pl", "pp", "tl",
    "AnnData", "read_h5ad", "write_h5ad", "settings", "profiling",
]
__version__ = "0.1.0"
