"""The measurement entry points' device handling: the compile-cache helper,
the GPU requirement of ``chip_smoke.py``/``bench.py``, the card line, and
``benchmarks/check_golden.py``'s device-named artifact."""

import json
import os
import subprocess
import sys

import pytest

from tests.util import REPO_ROOT

sys.path.insert(0, str(REPO_ROOT / "benchmarks"))
import check_golden  # noqa: E402

from bauklank.utils import compile_cache  # noqa: E402


def test_compile_cache_honours_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set the helper returns it and sets
    nothing in jax.config."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(REPO_ROOT / ".cache" / "jax")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        compile_cache.require_gpu()


@pytest.mark.parametrize(
    "line,watts",
    [("NVIDIA H100 80GB HBM3, 700.00 W", 700.0),
     ("NVIDIA H100 80GB HBM3, 500 W", 500.0),
     ("nvidia-smi unavailable (FileNotFoundError)", None)],
)
def test_power_limit_parse(line, watts):
    assert compile_cache.power_limit_w(line) == watts


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_scripts_fail_without_gpu(script):
    """No CPU fallback: on a machine without a GPU the script exits
    non-zero and prints no JSON result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(REPO_ROOT / script)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO_ROOT)
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    assert '"ok"' not in res.stdout and '"value"' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the rest of the repo fails."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO_ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, env=env, timeout=300, cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize(
    "kind,name",
    [("NVIDIA H100 80GB HBM3", "GOLDEN_NVIDIA_H100_80GB_HBM3.json"),
     ("NVIDIA H100 PCIe", "GOLDEN_NVIDIA_H100_PCIe.json"),
     ("cpu", "GOLDEN_cpu.json")],
)
def test_golden_artifact_named_after_device(kind, name):
    assert check_golden.artifact_name(kind) == name


def test_golden_artifact_name_rejects_empty_kind():
    with pytest.raises(ValueError):
        check_golden.artifact_name(" / ")


def test_golden_record_merges_subsets(tmp_path):
    """--record on a subset of cases keeps the cases it did not re-run
    and recomputes the floor over the union."""
    kind = "NVIDIA H100 80GB HBM3"
    path = tmp_path / check_golden.artifact_name(kind)
    full = check_golden.merge_record(
        path, kind, "card A", {"a": 50.0, "b": 44.0, "c": 90.0})
    path.write_text(json.dumps(full))
    sub = check_golden.merge_record(path, kind, "card A", {"b": 47.5})
    assert sub["cases"] == {"a": 50.0, "b": 47.5, "c": 90.0}
    assert sub["n_cases"] == 3 and sub["min_db"] == 47.5
    assert sub["failed"] == [] and sub["device_kind"] == kind
    path.write_text(json.dumps(sub))
    bad = check_golden.merge_record(path, kind, "card A", {"c": 39.0})
    assert bad["failed"] == ["c"] and bad["min_db"] == 39.0


def test_golden_record_refuses_other_device(tmp_path):
    path = tmp_path / check_golden.artifact_name("NVIDIA H100 80GB HBM3")
    path.write_text(json.dumps({"device_kind": "other", "cases": {"a": 1}}))
    with pytest.raises(ValueError, match="holds"):
        check_golden.merge_record(path, "NVIDIA H100 80GB HBM3", "x",
                                  {"a": 50.0})


def test_golden_floor_reads_own_device_only(tmp_path):
    kind = "NVIDIA H100 80GB HBM3"
    assert check_golden.golden_floor(kind, tmp_path) is None
    (tmp_path / check_golden.artifact_name(kind)).write_text(
        json.dumps({"device_kind": kind, "min_db": 44.5}))
    assert check_golden.golden_floor(kind, tmp_path) == 44.5
    assert check_golden.golden_floor("another card", tmp_path) is None
