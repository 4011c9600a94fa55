"""Global settings (figure saving, dataset cache, verbosity).

The reference delegates these to ``scanpy.settings`` (reference:
datasets/__init__.py:39, pl/_chromosome_heatmap.py:90); this framework is
standalone, so it carries its own small settings module.
"""

from __future__ import annotations

import os
from pathlib import Path

#: Directory where `save=` plots are written.
figdir = Path("./figures/")

#: Directory where downloaded / generated datasets are cached.
datasetdir = Path(os.environ.get("INFERCNVPY_TPU_DATA", "~/.cache/infercnvpy_tpu")).expanduser()

#: Whether plotting functions show figures by default.
autoshow = True

#: Default floating dtype for device compute ("float32" or "float64").
compute_dtype = "float32"

#: Verbosity: 0=errors, 1=warnings, 2=info, 3=debug
verbosity = 1

#: Compilation-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is not
#: set: one fixed path at the root of the checkout (listed in .gitignore).  The
#: path is part of the cache key, so it must not move between runs.
default_compilation_cache_dir = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compilation_cache(cache_dir: str | os.PathLike | None = None) -> None:
    """Enable JAX's persistent compilation cache for this process.

    First-call latency of the jitted pipeline is dominated by XLA
    compilation; the persistent cache makes every later process start hit the
    disk cache instead.  Called automatically on package import (set
    ``INFERCNVPY_TPU_NO_COMPILE_CACHE=1`` to opt out).

    With ``cache_dir=None``, a ``JAX_COMPILATION_CACHE_DIR`` in the
    environment wins (JAX reads it itself, so no directory is set here);
    otherwise the cache lives at :data:`default_compilation_cache_dir`.
    """
    import jax

    if cache_dir is not None or not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = Path(cache_dir) if cache_dir is not None else default_compilation_cache_dir
        path.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def _auto_enable_compilation_cache() -> None:  # called from package __init__
    if os.environ.get("INFERCNVPY_TPU_NO_COMPILE_CACHE", "") not in ("", "0"):
        return
    try:
        enable_compilation_cache()
    except OSError as exc:  # e.g. a read-only checkout: run uncached, but say so
        import warnings

        warnings.warn(f"JAX compilation cache not enabled: {exc}", stacklevel=2)
