"""tpu_qe — a vectorized query-execution engine on JAX.

A from-scratch JAX framework with the capabilities of the reference wgpu
morton-code radix sort harness (Andrewp2/wgpu_morton_code_radix_sort_test),
generalized into a columnar query engine:

- ``tpu_qe.native``   — C++ core: seeded data gen, morton LUTs, CPU oracles
- ``tpu_qe.morton``   — morton encoding on the device (JAX)
- ``tpu_qe.sort``     — u64 key sort drivers, in-core and out-of-core
- ``tpu_qe.exchange`` — multi-device collectives: distributed sort/shuffle
- ``tpu_qe.table``    — columnar device-resident tables
- ``tpu_qe.ops``      — query operators: filter, aggregate, join, window, ...
- ``tpu_qe.sql``      — SQL front end over the operators
- ``tpu_qe.bench``    — bytes-over-peak bounds + benchmark matrix
"""

__version__ = "0.2.0"

import os as _os

from tpu_qe import constants  # noqa: F401

CACHE_DIR = _os.path.join(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))), ".cache", "xla")


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache.

    Where JAX_COMPILATION_CACHE_DIR (or jax's own setting) names a cache,
    nothing is set here. Otherwise the cache is the fixed CACHE_DIR: the
    path is part of the cache key, so a path that moves never hits. CPU
    runs get no cache: XLA:CPU's executable (de)serializer has crashed the
    process both reading and writing entries.
    """
    import jax
    if jax.config.jax_compilation_cache_dir:
        return
    if str(jax.config.jax_platforms or "").split(",")[0].strip() == "cpu":
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


_enable_compile_cache()
