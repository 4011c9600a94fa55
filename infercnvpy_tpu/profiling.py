"""Trace capture and annotation on top of ``jax.profiler``.

The reference has no profiling subsystem at all (its only instrumentation is
tqdm progress bars, reference: tl/_infercnv.py:128); on an accelerator,
XLA-level traces are the primary performance tool, so this framework exposes
them first-class:

* :func:`trace` — context manager capturing a TensorBoard/XProf trace
  (``xplane.pb``) of everything executed inside it;
* :func:`annotate` — named region that shows up on the host timeline of a
  captured trace (wraps ``jax.profiler.TraceAnnotation``);
* ``INFERCNVPY_TPU_TRACE_DIR`` — when set, :func:`maybe_trace` (used by
  ``tl.infercnv``) captures a trace of every driver call into a fresh
  subdirectory, with zero code changes for the user.

This module is the *trace* side: per-op device timelines, fusion boundaries,
transfer overlap.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

__all__ = ["trace", "annotate", "maybe_trace", "last_trace_dir"]

#: Directory of the most recent capture (None until the first one completes).
last_trace_dir: str | None = None


@contextlib.contextmanager
def trace(logdir: str | os.PathLike):
    """Capture a device+host profiler trace of the enclosed block.

    The result is a TensorBoard ``plugins/profile/<run>`` directory readable
    by XProf / TensorBoard's profile plugin.  Works on GPU and CPU backends.

    >>> with profiling.trace("/tmp/cnv_trace"):
    ...     tl.infercnv(adata)
    """
    global last_trace_dir
    import jax

    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(str(path))
    try:
        yield str(path)
    finally:
        jax.profiler.stop_trace()
        last_trace_dir = str(path)


def annotate(name: str):
    """Named host-timeline region (context manager), nestable.

    Inside a :func:`trace` capture the region appears on the host track and
    scopes any device launches issued within it.
    """
    import jax

    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def maybe_trace(stage: str):
    """Capture a trace of this block iff ``INFERCNVPY_TPU_TRACE_DIR`` is set.

    Each capture lands in ``$INFERCNVPY_TPU_TRACE_DIR/<stage>-<timestamp>``
    so repeated driver calls never overwrite each other.  With the variable
    unset this is a zero-overhead no-op (no jax import, no context).
    """
    root = os.environ.get("INFERCNVPY_TPU_TRACE_DIR", "")
    if not root:
        yield None
        return
    dest = Path(root) / f"{stage}-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
    with trace(dest) as d:
        yield d
