"""Platform handling: the compile cache's location, and entry points that
refuse to run without a GPU unless the CPU is asked for (no silent
fallback).  The suite runs on the CPU, so "no GPU" is the case here."""

import json
import sys
from pathlib import Path

import jax
import pytest

from fluid_tpu.utils import platform

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cache_dir_config():
    """Restore JAX's cache-dir setting after a test changes it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env_var(monkeypatch, cache_dir_config):
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert platform.setup_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == "sentinel"  # nothing set


def test_compile_cache_default_is_fixed_ignored_path(monkeypatch, cache_dir_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.setup_compile_cache()
    assert path == ROOT / ".jax_cache" == platform.CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == str(path)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU found .*'cpu'"):
        platform.require_gpu()


def test_app_refuses_without_gpu(capsys):
    from fluid_tpu import app

    with pytest.raises(SystemExit, match="pass --cpu"):
        app.main(["--headless", "--frames", "1"])
    assert "--- frame" not in capsys.readouterr().out


def test_bench_refuses_without_gpu(capsys):
    sys.path.insert(0, str(ROOT))
    import bench

    with pytest.raises(SystemExit, match="pass --platform cpu"):
        bench.main(["--config", "2d-ref"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("argv", [[], ["--four-cards"]], ids=["one-card", "four-cards"])
def test_chip_smoke_refuses_without_gpu(argv, capsys):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    with pytest.raises(SystemExit, match="no GPU found"):
        chip_smoke.main(argv)
    out = capsys.readouterr().out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)  # no result line


def test_nvidia_smi_reports_without_raising():
    assert isinstance(platform.nvidia_smi(), str)


@pytest.mark.parametrize("shards", [None, 4], ids=["one-device", "shards-4"])
def test_app_runs_on_cpu_when_asked(shards, capsys):
    from fluid_tpu import app

    argv = ["--cpu", "--headless", "--frames", "1", "--particles", "192"]
    app.main(argv + (["--shards", str(shards)] if shards else []))
    assert "--- frame 0 ---" in capsys.readouterr().out
