"""Platform plumbing: the peak-bandwidth table, compile-cache placement, the
native library's rebuild rule, and the refusal to swap in CPU devices."""

import os
import shutil
import subprocess
import sys
import types

import pytest

from tpu_qe import native
from tpu_qe.bench import sol


def _dev(platform, kind):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                       ("NVIDIA H100 PCIe", 2.0e12)])
def test_peak_table_known_kinds(kind, peak):
    assert sol.hbm_peak_bytes_per_s(_dev("gpu", kind)) == peak


def test_peak_table_unknown_kind_raises():
    with pytest.raises(KeyError, match="no peak bandwidth"):
        sol.hbm_peak_bytes_per_s(_dev("gpu", "Some Future Card"))


def test_peak_table_cpu_is_not_measured():
    assert sol.hbm_peak_bytes_per_s(_dev("cpu", "cpu")) is None
    assert sol.hbm_peak_bytes_per_s() is None      # this suite runs on CPU


def test_bounds_are_none_on_cpu():
    assert sol.sort_sol_seconds(1 << 20, num_passes=8) is None
    assert sol.elementwise_seconds(1 << 20, 2) is None


def test_sort_pass_bytes_model():
    # read + write of 8 B keys and one 4 B payload column per element
    assert sol.sort_pass_bytes(1000) == 1000 * 24
    assert sol.sort_pass_bytes(1000, fused=False) == 1000 * 32


def _cache_dir(env_overrides: dict) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(env_overrides)
    r = subprocess.run(
        [sys.executable, "-c", "import tpu_qe, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_cache_dir_from_environment(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) \
        == str(tmp_path)


def test_cache_dir_fixed_in_checkout():
    import tpu_qe
    assert _cache_dir({}) == tpu_qe.CACHE_DIR
    assert tpu_qe.CACHE_DIR.endswith(os.path.join(".cache", "xla"))


def test_cache_off_for_cpu_runs():
    assert _cache_dir({"JAX_PLATFORMS": "cpu"}) == "None"


@pytest.fixture
def cpp_copy(tmp_path):
    src = os.path.join(os.path.dirname(native.__file__), "cpp")
    for name in ("core.cc", "Makefile"):
        shutil.copy(os.path.join(src, name), tmp_path / name)
    return tmp_path


def test_lib_path_keyed_by_source(cpp_copy):
    base = os.path.basename(native.lib_path())
    assert os.path.basename(native.lib_path(str(cpp_copy))) == base
    with open(cpp_copy / "core.cc", "a") as f:
        f.write("\n// edited\n")
    assert os.path.basename(native.lib_path(str(cpp_copy))) != base


def test_lib_path_keyed_by_machine(cpp_copy):
    assert native.lib_path(str(cpp_copy), "x86_64") \
        != native.lib_path(str(cpp_copy), "aarch64")


def test_build_once_then_reuse(cpp_copy):
    path = native.build(str(cpp_copy))
    assert os.path.exists(path)
    mtime = os.path.getmtime(path)
    assert native.build(str(cpp_copy)) == path
    assert os.path.getmtime(path) == mtime
    assert not [p for p in os.listdir(os.path.dirname(path))
                if p.endswith(".tmp")]


def test_dryrun_multichip_refuses_too_few_devices():
    import __graft_entry__ as g
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        g.dryrun_multichip(64)


def test_measure_blocks_until_ready():
    import jax.numpy as jnp

    from tpu_qe.utils.timing import measure
    x = jnp.arange(1 << 16, dtype=jnp.uint32)
    assert measure(lambda: x * 3 + 1, reps=2) > 0
