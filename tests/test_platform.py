"""Platform dispatch, compile-cache placement and the GPU smoke script's guard."""

import sys
from pathlib import Path

import jax
import pytest

from infercnvpy_tpu import settings
from infercnvpy_tpu.ops import infercnv_kernel as ik

ROOT = Path(__file__).resolve().parent.parent


def _plan(window, step):
    import pandas as pd

    from infercnvpy_tpu.genome import build_window_plan

    var = pd.DataFrame({"chromosome": ["chr1"] * 300, "start": range(300)})
    var["end"] = var["start"] + 1
    return build_window_plan(var, window, step)


def test_dispatch_cpu_takes_reference_path(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert ik.smooth_formulation(_plan(100, 10)) == "cumsum"
    assert ik.smooth_formulation(_plan(100, 1)) == "cumsum"


def test_dispatch_gpu_picks_by_tap_count(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ik.smooth_formulation(_plan(100, 10)) == "phase"
    assert ik.smooth_formulation(_plan(100, 1)) == "cumsum"


@pytest.mark.parametrize("platform", ["rocm", "METAL"])
def test_dispatch_unknown_platform_raises(monkeypatch, platform):
    plan = _plan(100, 10)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match=platform):
        ik.smooth_formulation(plan)
    with pytest.raises(RuntimeError, match=platform):
        ik.build_infercnv_fn(plan, n_ref_rows=1, lfc_clip=3.0, dynamic_threshold=1.5, num_chunks=1)


@pytest.fixture()
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env_var(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "from_env"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "from_env"))
    settings.enable_compilation_cache()
    # JAX reads the variable itself; the package sets no directory of its own
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "from_env")


def test_compile_cache_default_path_is_fixed(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    settings.enable_compilation_cache()
    first = jax.config.jax_compilation_cache_dir
    settings.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == first == str(ROOT / ".jax_cache")


def test_chip_smoke_refuses_cpu():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu()
