"""The GPU entry points' guards and pieces, on the CPU.

`chip_smoke.py` and `bench.py` must refuse to run (non-zero exit, no result line)
without a GPU; the peak table must refuse a device it does not list; the compile
cache follows JAX_COMPILATION_CACHE_DIR or else a fixed path in the repo. The
smoke test's correctness and jitter-ladder phases run here at small N against
their float64 references; the `gpu`-marked cases run them on a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from gaussian_process_optimization_tpu.utils import compile_cache  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_no_result(proc):
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    if lines:
        with pytest.raises(ValueError):
            json.loads(lines[-1])


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script):
    _assert_no_result(_run([script], ROOT))


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_no_result(_run(["chip_smoke.py"], tmp_path))


def test_peak_table_refuses_unknown_device():
    assert bench.peak_for("NVIDIA H100 80GB HBM3")["fp32_tflops"] == 67.0
    with pytest.raises(KeyError):
        bench.peak_for("cpu")


def test_cache_dir_follows_environment():
    path, from_env = compile_cache.cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/some/cache"})
    assert (path, from_env) == ("/some/cache", True)
    path, from_env = compile_cache.cache_dir({})
    assert (path, from_env) == (str(ROOT / ".jax_cache"), False)


def test_enable_compile_cache_sets_nothing_when_env_set(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_matern52_twin_matches_gp_regression(rng):
    """The smoke test's float64 numpy twin agrees with models/gp.py (float64
    here) on the K build, the negative LML and every hyperparameter gradient."""
    X = rng.uniform(-2, 2, size=(40, 6))
    Y = np.sin(X[:, :1]) + 0.05 * rng.standard_normal((40, 1))
    model = chip_smoke.headline_model(X, Y)
    K, nlml, g = chip_smoke.matern52_twin(
        X, Y, chip_smoke.VARIANCE, np.asarray(chip_smoke.LENGTHSCALES),
        chip_smoke.NOISE)
    np.testing.assert_allclose(np.asarray(model.kern.K(model.X)), K,
                               rtol=1e-10, atol=1e-12)
    nlml_gp, g_gp = chip_smoke.device_lml_grad(model, "highest")
    np.testing.assert_allclose(nlml_gp, nlml, rtol=1e-10)
    np.testing.assert_allclose(g_gp, g, rtol=1e-7, atol=1e-9)


def test_correctness_phase_small():
    X, Y = bench._data(n=96)
    chip_smoke.correctness_phase(X, Y)


def test_host_ladder_rung():
    assert chip_smoke.host_ladder_rung(np.eye(4)) == 0
    assert chip_smoke.host_ladder_rung(-np.eye(4)) == 6


def test_gram_with_spectrum_needs_rung_four():
    assert chip_smoke.host_ladder_rung(chip_smoke.gram_with_spectrum(256)) == 4


def test_ladder_phase_small():
    chip_smoke.ladder_phase(512)


def test_check_raises_past_bound():
    chip_smoke.check("within", 1e-6, 1e-5)
    with pytest.raises(AssertionError):
        chip_smoke.check("past", 1e-4, 1e-5)
    with pytest.raises(AssertionError):
        chip_smoke.check("nan", float("nan"), 1e-5)


def test_multichip_phase_on_virtual_devices():
    """The --chips 4 path, at small sizes, on 4 of the 8 virtual CPU devices."""
    chip_smoke.multichip_phase(4, n=128, n_big=256, nb=32, platform="cpu")


@pytest.mark.gpu
def test_correctness_on_gpu(gpu):
    X, Y = bench._data(n=1024)
    chip_smoke.correctness_phase(X, Y)


@pytest.mark.gpu
def test_ladder_contract_on_gpu(gpu):
    chip_smoke.ladder_phase(1024)
