"""Runtime set-up, the native library's build key, and the entry scripts
(``chip_smoke.py``, ``bench.py``) at tiny sizes on the CPU.  Tests marked
``gpu`` run the same checks on a GPU and skip without one."""
import os
import pathlib
import sys

import jax
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


@pytest.fixture
def no_cache_writes(monkeypatch, tmp_path):
    """Point the compile cache at a temporary directory for the test.
    ``enable_compile_cache`` then sets nothing, since JAX reads the
    variable only when it is imported."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))


def test_compile_cache_uses_the_variable_when_set(no_cache_writes):
    from cpkrylov_tpu.utils.runtime import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == os.environ["JAX_COMPILATION_CACHE_DIR"]
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    from cpkrylov_tpu.utils.runtime import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_library_key_follows_sources_and_flags(tmp_path):
    from cpkrylov_tpu.native import build

    src = tmp_path / "kernel.cpp"
    src.write_text("int f() { return 1; }\n")
    k1 = build.library_key([str(src)])
    assert build.library_key([str(src)]) == k1
    src.write_text("int f() { return 2; }\n")
    k2 = build.library_key([str(src)])
    assert k2 != k1
    assert build.library_key([str(src)], flags=("-O2",)) != k2
    assert build.library_path().endswith(f"-{build.library_key()}.so")


def test_bench_peak_table():
    assert bench.peak_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError):
        bench.peak_bandwidth("Unlisted Accelerator 1")


def test_chip_smoke_refuses_a_cpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert '"ok": true' not in out.out
    assert "no gpu device" in out.err


def test_chip_smoke_phases_tiny(no_cache_writes):
    dev = chip_smoke.phase_device("cpu")
    assert dev["platform"] == "cpu"
    res = chip_smoke.phase_parity(chip_smoke.PARITY_CASES[-1:])
    assert res[0][2] == pytest.approx(120, abs=2)
    flag = chip_smoke.phase_flagship(4000, 1000, repeats=1, reps=2)
    assert flag["rel"] <= 1e-6
    mixed = chip_smoke.phase_mixed(flag["sysm"], npairs=10_000)
    assert mixed["agree"] <= 1e-6


def test_chip_smoke_four_on_virtual_devices():
    # Virtual devices 4-7: device 0 doubles as the host staging device.
    out = chip_smoke.phase_four(8000, 2000, ndev=4,
                                devices=jax.devices()[4:8])
    assert out["diff"] <= 1e-6
    assert len(out["resident"]) == 4


@pytest.mark.gpu
def test_gpu_df64_transforms_exact(gpu):
    with jax.default_device(gpu):
        chip_smoke._df64_exact(1_000_000, seed=1)


@pytest.mark.gpu
def test_gpu_parity_cvxqp2(gpu):
    with jax.default_device(gpu):
        res = chip_smoke.phase_parity(chip_smoke.PARITY_CASES[-2:])
    assert [r[2] for r in res] == pytest.approx([127, 120], abs=2)
